"""Dataset factory (the port's own copy of ``arflow_tpu/data/get_dataset.py``).

Builds (train ConcatDataset | None, [valid datasets]) from cfg.data entries.
All transforms share one ``RandomState(seed)``.
"""

from __future__ import annotations

import numpy as np

from arflow_tpu_torch.data.datasets import (
    Chairs,
    Chairs2,
    ConcatDataset,
    KITTIFlow,
    KITTIFlowMV,
    Sintel,
    Things3D,
)
from arflow_tpu_torch.data.transforms import (
    Compose,
    Scale,
    get_geometric_transforms,
    get_photometric_transforms,
)


def get_dataset(all_cfg, seed: int = 0):
    cfgs = all_cfg.data
    train_set = []
    valid_set = []
    rng = np.random.RandomState(seed)

    for cfg in cfgs:
        geometric_transform = (
            get_geometric_transforms(cfg.geometric_aug, rng)
            if "geometric_aug" in cfg
            else None
        )
        photometric_transform = (
            get_photometric_transforms(cfg.photometric_aug, rng)
            # "device": true moves this augmentation into UFlowTrainer's
            # step on the card (data/device_aug.py); the dataset then emits
            # no _ph copies.
            if "photometric_aug" in cfg and not cfg.photometric_aug.get("device")
            else None
        )
        valid_transform = (
            Compose([Scale(size=cfg.test_shape)]) if "test_shape" in cfg else None
        )

        if cfg.name == "Sintel":
            if cfg.type == "train":
                train_set.append(
                    Sintel(
                        cfg.root_sintel, n_frames=cfg.n_frames, split=cfg.split,
                        type="clean" if cfg.clean else "final",
                        subsplit=cfg.subsplit, with_flow=False,
                        geometric_transform=geometric_transform,
                        photometric_transform=photometric_transform,
                    )
                )
            else:
                valid_set.append(
                    Sintel(
                        cfg.root_sintel, n_frames=cfg.n_frames, split=cfg.split,
                        type="clean" if cfg.clean else "final",
                        subsplit=cfg.subsplit,
                        with_flow=cfg.get("with_flow", True),
                        geometric_transform=valid_transform,
                    )
                )
        elif cfg.name == "Chairs2":
            if cfg.type == "train":
                train_set.append(
                    Chairs2(
                        cfg.root_chairs, n_frames=cfg.n_frames, split=cfg.split,
                        with_flow=False,
                        geometric_transform=geometric_transform,
                        photometric_transform=photometric_transform,
                    )
                )
            else:
                valid_set.append(
                    Chairs2(
                        cfg.root_chairs, n_frames=cfg.n_frames, split=cfg.split,
                        with_flow=cfg.get("with_flow", True),
                        geometric_transform=valid_transform,
                    )
                )
        elif cfg.name == "Chairs":
            if cfg.type == "train":
                train_set.append(
                    Chairs(
                        cfg.root_chairs, n_frames=cfg.n_frames,
                        split=cfg.get("split", "train"),
                        # Supervised (mse) training needs GT flow in the
                        # train stream; unsupervised configs leave it off.
                        with_flow=cfg.get("with_flow", False),
                        geometric_transform=geometric_transform,
                        photometric_transform=photometric_transform,
                    )
                )
            else:
                valid_set.append(
                    Chairs(
                        cfg.root_chairs, n_frames=cfg.n_frames,
                        split=cfg.get("split", "valid"),
                        with_flow=cfg.get("with_flow", True),
                        geometric_transform=valid_transform,
                    )
                )
        elif cfg.name == "KITTI":
            if cfg.type == "train":
                train_set.append(
                    KITTIFlow(
                        cfg.root, n_frames=cfg.n_frames, split=cfg.split,
                        with_flow=False,
                        geometric_transform=geometric_transform,
                        photometric_transform=photometric_transform,
                    )
                )
            else:
                valid_set.append(
                    KITTIFlow(
                        cfg.root, n_frames=cfg.n_frames, split=cfg.split,
                        with_flow=cfg.get("with_flow", True),
                        geometric_transform=valid_transform,
                    )
                )
        elif cfg.name == "KITTIMV":
            if cfg.type == "train":
                train_set.append(
                    KITTIFlowMV(
                        cfg.root, n_frames=cfg.n_frames,
                        geometric_transform=geometric_transform,
                        photometric_transform=photometric_transform,
                    )
                )
            else:
                valid_set.append(
                    KITTIFlowMV(
                        cfg.root, n_frames=cfg.n_frames,
                        geometric_transform=valid_transform,
                    )
                )
        elif cfg.name == "Things":
            if cfg.type == "train":
                train_set.append(
                    Things3D(
                        cfg.root, n_frames=cfg.n_frames, split=cfg.split,
                        geometric_transform=geometric_transform,
                        photometric_transform=photometric_transform,
                    )
                )
            else:
                raise NotImplementedError(cfg.type)
        else:
            raise NotImplementedError(cfg.name)

    train = ConcatDataset(train_set) if train_set else None
    return train, valid_set
