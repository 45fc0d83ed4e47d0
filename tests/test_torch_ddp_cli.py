"""``arflow-torch-train`` on 2 ranks over gloo on the CPU: ``train_cli
--coordinator localhost:<port> --num_processes 2 --process_id i --device
cpu``, one process each, on a synthetic FlyingChairs tree
(``tests/torch_data_util.py``; ``chairs_uflow.json`` at 64x96, global
batch 4, the augmentation off, so that a resume can be bit for bit):

- one ``save_root`` (rank 0's clock), in which rank 0 alone writes the
  checkpoints, ``events.jsonl`` and the images (each row once);
- the validation's two batches split over the ranks, its EPE the same as
  one process's;
- a resumed 2-rank run equal bit for bit to the unbroken one;
- and a NaN in one rank's rows under ``nan_revert``: both ranks revert
  the step and keep one state."""

import glob
import json
import os
import sys

import numpy as np
import torch

from arflow_tpu_torch import Config
from arflow_tpu_torch.models import get_model
from torch_data_util import few_torch_threads, make_chairs_dir  # noqa: F401
from torch_ddp_util import Processes, Ranks, free_port, train_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "chairs_uflow.json")
H, W = 64, 96
_TRAIN = "import sys; from arflow_tpu_torch.cli import train_cli; train_cli(sys.argv[1:])"


def write_config(path, root, epochs):
    with open(CONFIG) as f:
        d = json.load(f)
    for entry in d["data"]:
        entry["root_chairs"] = str(root)
        entry.pop("geometric_aug", None)
        entry.pop("photometric_aug", None)
    d["loss"]["smooth_order"] = 1
    d["train"].update(batch_size=4, epoch_num=epochs, epoch_size=1, valid_freq=1,
                      save_iter=0, workers=2, print_freq=1, record_freq=1)
    with open(path, "w") as f:
        json.dump(d, f)
    return str(path)


def start_2_ranks(cwd, config, resume=None) -> Processes:
    """Both ranks of ``arflow-torch-train`` started in ``cwd``."""
    os.makedirs(cwd, exist_ok=True)
    port = free_port()
    extra = [] if resume is None else ["--resume", resume]
    return Processes([[sys.executable, "-c", _TRAIN, "-c", config, "--coordinator",
                       f"localhost:{port}", "--num_processes", "2", "--process_id",
                       str(r), "--device", "cpu", *extra] for r in range(2)], cwd)


def save_root_of(cwd) -> str:
    roots = glob.glob(os.path.join(cwd, "outputs", "checkpoints", "*", "*"))
    assert len(roots) == 1, roots  # one save_root for both ranks
    return roots[0]


def train_2_ranks(cwd, config, resume=None):
    """Both ranks of ``arflow-torch-train`` in ``cwd``; their save_root."""
    start_2_ranks(cwd, config, resume).wait()
    return save_root_of(cwd)


def test_train_cli_two_ranks_resume_bit_for_bit(tmp_path):
    # fids 1-18: 6 and 18 are the valid split, 16 train pairs make 4
    # global batches, of which an epoch takes 2 (epoch_size 1)
    root = make_chairs_dir(tmp_path / "chairs", np.random.RandomState(5), 18, H, W)
    # runs a and b at once: 4 processes
    first = [start_2_ranks(tmp_path / r, write_config(tmp_path / f"{r}.json", root, n))
             for r, n in (("a", 2), ("b", 1))]
    try:
        for procs in first:
            procs.wait()
    finally:
        for procs in first:
            procs.kill()
    run_a, run_b = save_root_of(tmp_path / "a"), save_root_of(tmp_path / "b")
    run_c = train_2_ranks(tmp_path / "c", write_config(tmp_path / "c.json", root, 2),
                          resume=os.path.join(run_b, "Chairs_ckpt.pth.tar"))

    names = sorted(os.listdir(run_a))
    logs = [n for n in names if n.endswith(".log")]
    assert len(logs) == 2 and sum(n.endswith("_rank1.log") for n in logs) == 1
    assert {"Chairs_ckpt.pth.tar", "Chairs_model_best.pth.tar", "events.jsonl",
            "images"} <= set(names)
    assert not any("rank1" in n for n in names if not n.endswith(".log"))
    with open(os.path.join(run_a, "events.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    keys = [(r["tag"], r["step"]) for r in rows]
    assert len(keys) == len(set(keys))  # rank 0's rows, each once
    epe = [r["value"] for r in rows if r["tag"] == "Valid_EPE_0"]
    assert len(epe) == 2 and np.isfinite(epe).all()
    images = sorted(os.listdir(os.path.join(run_a, "images")))
    assert images and all(n.endswith(".png") for n in images)

    a = torch.load(os.path.join(run_a, "Chairs_ckpt.pth.tar"), weights_only=True)
    c = torch.load(os.path.join(run_c, "Chairs_ckpt.pth.tar"), weights_only=True)
    assert (a["epoch"], a["i_iter"]) == (c["epoch"], c["i_iter"]) == (2, 4)
    for k, v in a["state_dict"].items():
        assert torch.equal(v, c["state_dict"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, c["optimizer"]["state"][i][k]), (i, k)
    assert a["opt_count"] == c["opt_count"] == 4
    assert torch.equal(a["generator"], c["generator"])
    with open(os.path.join(run_c, "events.jsonl")) as f:
        epe_c = [json.loads(line)["value"] for line in f
                 if json.loads(line)["tag"] == "Valid_EPE_0"]
    assert epe_c == epe[1:]


def test_nan_on_one_rank_reverts_on_both(tmp_path):
    torch.save(get_model(Config({"type": "uflow", "feature_norm": True}),
                         device="cpu", seed=0).state_dict(), tmp_path / "w.pt")
    rs = np.random.RandomState(7)
    batches = [{"img1": rs.rand(4, H, W, 3), "img2": rs.rand(4, H, W, 3)}
               for _ in range(3)]
    batches[1]["img1"][3, 5, 7] = np.nan  # a row of rank 1
    case = {"trainer": "uflow", "model": {"type": "uflow", "feature_norm": True,
                                          "level_dropout": 0.0},
            "loss": {"type": "uflow", "edge_constant": 150.0, "w_smooth": 4.0,
                     "w_census": 1.0, "smooth_order": 1, "with_bk": True},
            "train": {"batch_size": 4, "epoch_num": 1, "epoch_size": 1000,
                      "lr": 1e-4, "lr_decay_start_epoch": 100,
                      "lr_decay_factor": 0.5, "optim": "adam",
                      "weight_decay": 0.0, "bias_decay": 0.0, "print_freq": 100,
                      "record_freq": 1, "save_iter": 10**9, "valid_freq": 10**9,
                      "valid_size": 0, "seed": 0, "nan_revert": True},
            "state_dict": str(tmp_path / "w.pt"), "batches": batches}
    ranks = Ranks(case, tmp_path / "ranks", world=2)
    one = train_case(case)  # the one-process run on the global batches
    ranks = ranks.results()
    for r in ranks:
        assert r["nan_skips"] == 1 and r["count"] == 2 and r["i_iter"] == 3
        assert not np.isfinite(r["records"][1][0])
        assert np.isfinite(np.delete(np.array(r["records"]), 1, axis=0)).all()
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k
    # the one-process run reverts the same step
    assert one["nan_skips"] == 1 and one["count"] == 2
    for k, v in ranks[0]["state"].items():
        if v.is_floating_point():
            assert float((v - one["state"][k]).norm()) <= 1e-5 * max(
                float(one["state"][k].norm()), 1e-30), k
