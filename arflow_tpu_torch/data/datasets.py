"""Dataset catalogs: Sintel, FlyingChairs(2), KITTI, FlyingThings3D (the
port's own copy of ``arflow_tpu/data/datasets.py``), numpy samples.

Input sample dict keys (``collect_samples``): 'imgs', 'flow', 'flow_occ',
'flow_noc', 'mask', 'flow_bw'.

Output dict per item: 'img{i}' (H,W,3 float32 [0,1] geometric-augmented),
'img{i}_ph' (photometric-augmented), 'img{i}_orgsize', 'img{i}_rpath',
'target' {'flow': (H,W,2|4), 'mask', 'flow_bw'}.

Images decode to float32 ``px / 255.0``. Binary PPM and PGM (FlyingChairs)
decode in numpy; PNG and JPG (Sintel, KITTI, FlyingChairs2, Things3D) need
PIL, imported at the call.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path

import numpy as np

from arflow_tpu_torch.utils.flow_io import load_flow

PNM_SUFFIXES = (".ppm", ".pgm", ".pnm")


def _pnm_header(data: bytes, path):
    """The four header fields of a binary PNM (magic, width, height,
    maxval) and the offset of its pixels: fields are separated by
    whitespace, '#' starts a comment to the end of its line, and one
    whitespace byte ends the header."""
    fields, pos, n = [], 0, len(data)
    while len(fields) < 4:
        if pos >= n:
            raise ValueError(f"{path}: truncated PNM header")
        c = data[pos:pos + 1]
        if c == b"#":
            end = data.find(b"\n", pos)
            pos = n if end < 0 else end + 1
        elif c.isspace():
            pos += 1
        else:
            end = pos
            while end < n and not data[end:end + 1].isspace() \
                    and data[end:end + 1] != b"#":
                end += 1
            fields.append(data[pos:end])
            pos = end
    return fields, pos + 1


def read_pnm(path) -> np.ndarray:
    """A binary PPM (P6) or PGM (P5) with maxval 255 -> (H, W, 3) float32
    in [0, 1], ``px / 255.0``: what PIL's ``convert("RGB")`` and the same
    division give, bit for bit (a PGM's gray value in all three
    channels)."""
    with open(path, "rb") as f:
        data = f.read()
    (magic, w, h, maxval), offset = _pnm_header(data, path)
    if magic not in (b"P6", b"P5"):
        raise ValueError(f"{path}: not a binary PPM/PGM (magic {magic!r})")
    w, h, maxval = int(w), int(h), int(maxval)
    if maxval != 255:
        raise ValueError(f"{path}: maxval {maxval}; only 8-bit (255) is read")
    c = 3 if magic == b"P6" else 1
    px = np.frombuffer(data, np.uint8, count=h * w * c, offset=offset)
    px = px.reshape(h, w, c)
    if c == 1:
        px = np.repeat(px, 3, axis=2)
    return px.astype(np.float32) / 255.0


def load_image(path) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]: PPM/PGM in numpy, other formats
    through PIL."""
    if str(path).lower().endswith(PNM_SUFFIXES):
        return read_pnm(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding {Path(path).suffix} images ({path}) needs PIL "
            "(pillow), which is not installed; PPM/PGM decode without it"
        ) from e
    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
    return arr


class ImgSeqDataset(ABC):
    def __init__(self, root, n_frames=2, geometric_transform=None,
                 photometric_transform=None):
        self.root = Path(root)
        self.n_frames = n_frames
        self.geometric_transform = geometric_transform
        self.photometric_transform = photometric_transform
        self.samples = self.collect_samples()

    @abstractmethod
    def collect_samples(self):
        ...

    def _load_sample(self, s):
        images = np.stack([load_image(self.root / p) for p in s["imgs"]])
        target = {}
        if "flow" in s:
            target["flow"] = load_flow(self.root / s["flow"]).astype(np.float32)
        if "flow_occ" in s and "flow_noc" in s:
            flow_occ = load_flow(self.root / s["flow_occ"]).astype(np.float32)
            flow_noc = load_flow(self.root / s["flow_noc"]).astype(np.float32)
            # [u, v, occ_mask, noc_mask] (flow_datasets.py:75-78)
            target["flow"] = np.concatenate([flow_occ, flow_noc[:, :, 2:3]], axis=-1)
        if "mask" in s:
            mask = load_image(self.root / s["mask"])[:, :, 0:1]
            target["mask"] = mask
        if "flow_bw" in s:
            target["flow_bw"] = load_flow(self.root / s["flow_bw"]).astype(np.float32)
        return images, target

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        images, target = self._load_sample(self.samples[idx])
        data = {
            f"img{i + 1}_orgsize": np.asarray(img.shape)[None, :]
            for i, img in enumerate(images)
        }
        if self.geometric_transform is not None:
            images = self.geometric_transform(images)
        data.update({f"img{i + 1}": img for i, img in enumerate(images)})
        if self.photometric_transform is not None:
            images_ph = self.photometric_transform(images)
            data.update(
                {f"img{i + 1}_ph": img for i, img in enumerate(images_ph)}
            )
        data["target"] = target
        data.update(
            {
                f"img{i + 1}_rpath": str(p)
                for i, p in enumerate(self.samples[idx]["imgs"])
            }
        )
        return data


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1]) if len(self.datasets) else 0

    def __getitem__(self, idx):
        ds_idx = int(np.searchsorted(self._offsets, idx, side="right"))
        prev = 0 if ds_idx == 0 else int(self._offsets[ds_idx - 1])
        return self.datasets[ds_idx][idx - prev]


class SintelRaw(ImgSeqDataset):
    """flow_datasets.py:115-131: all consecutive n-frame windows per scene."""

    def collect_samples(self):
        samples = []
        for scene in sorted(p for p in self.root.iterdir() if p.is_dir()):
            img_list = sorted(scene.glob("*.png"))
            for st in range(0, len(img_list) - self.n_frames + 1):
                seq = img_list[st : st + self.n_frames]
                samples.append(
                    {"imgs": [p.relative_to(self.root) for p in seq]}
                )
        return samples


class Sintel(ImgSeqDataset):
    """flow_datasets.py:134-192 with the unofficial train/val scene split."""

    TRAINING_SCENES = [
        "alley_1", "ambush_4", "ambush_6", "ambush_7", "bamboo_2",
        "bandage_2", "cave_2", "market_2", "market_5", "shaman_2",
        "sleeping_2", "temple_3",
    ]

    def __init__(self, root, n_frames=2, type="final", split="train",
                 subsplit="trainval", with_flow=True, geometric_transform=None,
                 photometric_transform=None):
        if subsplit != "trainval" and split != "train":
            raise ValueError("Subsplits are defined only for the training split.")
        self.dataset_type = type
        self.with_flow = with_flow
        self.first_level = Path("training" if split == "train" else "test")
        self.subsplit = subsplit
        super().__init__(root, n_frames, geometric_transform, photometric_transform)

    def collect_samples(self):
        img_dir = self.first_level / self.dataset_type
        flow_dir = self.first_level / "flow"
        assert (self.root / img_dir).is_dir()
        assert (self.root / flow_dir).is_dir() or not self.with_flow

        samples = []
        for img in sorted((self.root / img_dir).glob("*/*.png")):
            scene = img.parent.name
            fid = int(img.stem[-4:])
            if self.subsplit != "trainval":
                if self.subsplit == "train" and scene not in self.TRAINING_SCENES:
                    continue
                if self.subsplit == "val" and scene in self.TRAINING_SCENES:
                    continue
            s = {
                "imgs": [
                    img_dir / scene / f"frame_{fid + i:04d}.png"
                    for i in range(self.n_frames)
                ]
            }
            if not all((self.root / p).is_file() for p in s["imgs"]):
                continue
            if self.with_flow:
                if self.n_frames == 3:
                    s["flow"] = flow_dir / scene / f"frame_{fid + 1:04d}.flo"
                elif self.n_frames == 2:
                    s["flow"] = flow_dir / scene / f"frame_{fid:04d}.flo"
                else:
                    raise NotImplementedError(
                        f"n_frames {self.n_frames} with flow"
                    )
                if not (self.root / s["flow"]).is_file():
                    continue
            samples.append(s)
        return samples


class Chairs2(ImgSeqDataset):
    """FlyingChairs2 with forward+backward GT flow (flow_datasets.py:195-228)."""

    def __init__(self, root, n_frames=2, split="train", with_flow=True,
                 geometric_transform=None, photometric_transform=None):
        self.with_flow = with_flow
        self.first_level = Path("train" if split == "train" else "val")
        super().__init__(root, n_frames, geometric_transform, photometric_transform)

    def collect_samples(self):
        if self.n_frames > 2:
            raise NotImplementedError(f"n_frames {self.n_frames}")
        samples = []
        for flow_map in sorted((self.root / self.first_level).glob("*flow_01.flo")):
            fid = int(flow_map.name[0:7])
            s = {
                "imgs": [
                    self.first_level / f"{fid:07d}-img_{i:d}.png"
                    for i in range(self.n_frames)
                ]
            }
            assert all((self.root / p).is_file() for p in s["imgs"])
            if self.with_flow:
                s["flow"] = self.first_level / f"{fid:07d}-flow_01.flo"
                s["flow_bw"] = self.first_level / f"{fid:07d}-flow_10.flo"
                assert (self.root / s["flow"]).is_file()
                assert (self.root / s["flow_bw"]).is_file()
            samples.append(s)
        return samples


# The fork's hardcoded FlyingChairs validation indices
# (datasets/flow_datasets.py:236-273).
CHAIRS_VALID_INDICES = frozenset(
    [
        6, 18, 43, 46, 59, 63, 97, 112, 118, 121, 122, 132, 133, 153, 161, 249,
        264, 265, 292, 294, 296, 300, 317, 321, 337, 338, 344, 359, 400, 402,
        430, 439, 469, 477, 495, 510, 529, 532, 573, 582, 584, 589, 594, 682,
        689, 697, 715, 768, 787, 811, 826, 837, 842, 884, 918, 938, 943, 971,
        975, 981, 1017, 1044, 1065, 1119, 1122, 1134, 1154, 1156, 1159, 1160,
        1174, 1188, 1220, 1238, 1239, 1260, 1267, 1279, 1297, 1355, 1379, 1388,
        1495, 1509, 1519, 1575, 1602, 1615, 1669, 1674, 1700, 1713, 1715, 1738,
        1842, 1873, 1880, 1902, 1922, 1935, 1962, 1968, 1979, 2019, 2031, 2040,
        2044, 2062, 2114, 2205, 2217, 2237, 2251, 2275, 2293, 2311, 2343, 2360,
        2375, 2383, 2400, 2416, 2420, 2484, 2503, 2505, 2577, 2590, 2591, 2623,
        2625, 2637, 2652, 2656, 2659, 2660, 2665, 2673, 2707, 2708, 2710, 2726,
        2733, 2762, 2828, 2865, 2867, 2906, 2923, 2930, 2967, 2973, 2994, 3011,
        3026, 3032, 3041, 3042, 3071, 3114, 3125, 3130, 3138, 3142, 3158, 3184,
        3207, 3220, 3248, 3254, 3273, 3277, 3322, 3329, 3334, 3339, 3342, 3347,
        3352, 3397, 3420, 3431, 3434, 3449, 3456, 3464, 3504, 3527, 3530, 3538,
        3556, 3578, 3585, 3592, 3595, 3598, 3604, 3614, 3616, 3671, 3677, 3679,
        3698, 3724, 3729, 3735, 3746, 3751, 3753, 3780, 3783, 3814, 3818, 3820,
        3855, 3886, 3945, 3948, 3971, 3986, 4012, 4023, 4072, 4076, 4133, 4159,
        4168, 4191, 4195, 4208, 4247, 4250, 4299, 4308, 4318, 4319, 4320, 4321,
        4383, 4400, 4402, 4408, 4417, 4424, 4485, 4492, 4494, 4518, 4526, 4539,
        4579, 4607, 4610, 4621, 4624, 4638, 4647, 4663, 4669, 4717, 4740, 4748,
        4771, 4775, 4777, 4786, 4801, 4846, 4864, 4892, 4905, 4923, 4926, 4957,
        4964, 4965, 4995, 5012, 5020, 5037, 5039, 5042, 5056, 5119, 5123, 5131,
        5163, 5165, 5179, 5197, 5228, 5267, 5271, 5274, 5280, 5300, 5311, 5315,
        5364, 5376, 5385, 5394, 5415, 5418, 5434, 5449, 5495, 5506, 5510, 5526,
        5567, 5582, 5603, 5610, 5621, 5654, 5671, 5679, 5691, 5701, 5704, 5725,
        5753, 5766, 5804, 5812, 5861, 5882, 5896, 5913, 5916, 5941, 5953, 5967,
        5978, 5989, 6008, 6038, 6062, 6070, 6081, 6112, 6128, 6147, 6162, 6167,
        6169, 6179, 6183, 6191, 6221, 6236, 6254, 6271, 6344, 6373, 6380, 6411,
        6412, 6443, 6454, 6482, 6499, 6501, 6510, 6533, 6542, 6544, 6561, 6577,
        6581, 6595, 6596, 6610, 6626, 6630, 6645, 6659, 6674, 6681, 6699, 6700,
        6703, 6706, 6742, 6760, 6786, 6793, 6795, 6810, 6811, 6831, 6839, 6870,
        6872, 6890, 6926, 6996, 7004, 7027, 7030, 7081, 7083, 7098, 7103, 7117,
        7166, 7201, 7233, 7272, 7283, 7325, 7334, 7336, 7373, 7388, 7408, 7473,
        7475, 7483, 7490, 7500, 7517, 7534, 7537, 7567, 7621, 7655, 7692, 7705,
        7723, 7747, 7751, 7774, 7807, 7822, 7828, 7852, 7874, 7881, 7885, 7905,
        7913, 7949, 7965, 7966, 7985, 7990, 7993, 8036, 8051, 8075, 8092, 8095,
        8114, 8117, 8152, 8160, 8172, 8180, 8195, 8196, 8240, 8264, 8291, 8296,
        8313, 8368, 8375, 8388, 8408, 8438, 8440, 8519, 8557, 8589, 8598, 8602,
        8652, 8658, 8724, 8760, 8764, 8786, 8803, 8814, 8827, 8855, 8857, 8867,
        8919, 8923, 8924, 8933, 8959, 8968, 9004, 9019, 9079, 9096, 9105, 9113,
        9130, 9148, 9171, 9172, 9198, 9201, 9250, 9254, 9271, 9283, 9289, 9296,
        9322, 9324, 9325, 9348, 9400, 9404, 9418, 9427, 9428, 9440, 9469, 9487,
        9497, 9512, 9517, 9519, 9530, 9558, 9564, 9565, 9585, 9587, 9592, 9600,
        9601, 9602, 9633, 9655, 9668, 9679, 9697, 9717, 9724, 9741, 9821, 9825,
        9826, 9829, 9864, 9867, 9869, 9890, 9930, 9939, 9954, 9968, 10020,
        10021, 10026, 10060, 10112, 10119, 10126, 10175, 10195, 10202, 10203,
        10221, 10222, 10227, 10243, 10251, 10277, 10296, 10303, 10306, 10328,
        10352, 10361, 10370, 10394, 10408, 10439, 10456, 10464, 10466, 10471,
        10479, 10504, 10509, 10510, 10810, 11081, 11332, 11608, 11611, 11865,
        12391, 12394, 12397, 12400, 12672, 12922, 12931, 13179, 13454, 13718,
        14500, 14518, 14776, 15298, 15557, 15835, 15840, 16127, 16128, 16387,
        16634, 16645, 16652, 17167, 17170, 17959, 17960, 17963, 18225, 21177,
        21181, 21191, 21803, 21804, 21807, 22585, 22858, 22859, 22867,
    ]
)


class Chairs(ImgSeqDataset):
    """FlyingChairs with the fork's hardcoded val split
    (flow_datasets.py:231-317)."""

    def __init__(self, root, n_frames=2, split="trainval", with_flow=True,
                 geometric_transform=None, photometric_transform=None):
        self.with_flow = with_flow
        self.split = split
        super().__init__(root, n_frames, geometric_transform, photometric_transform)

    def collect_samples(self):
        samples = []
        for flow_map in sorted(self.root.glob("*.flo")):
            fid = int(flow_map.name[0:5])
            if self.split == "train" and fid in CHAIRS_VALID_INDICES:
                continue
            if self.split == "valid" and fid not in CHAIRS_VALID_INDICES:
                continue
            if self.split not in ("train", "valid", "trainval"):
                raise ValueError(f"Split {self.split} is undefined")
            s = {
                "imgs": [
                    Path(f"{fid:05d}_img{i + 1:d}.ppm")
                    for i in range(self.n_frames)
                ]
            }
            if not all((self.root / p).is_file() for p in s["imgs"]):
                continue
            if self.with_flow:
                if self.n_frames != 2:
                    raise NotImplementedError(
                        f"n_frames {self.n_frames} with flow"
                    )
                s["flow"] = flow_map.relative_to(self.root)
            samples.append(s)
        return samples


class KITTIFlowMV(ImgSeqDataset):
    """KITTI multiview, unsupervised training only (flow_datasets.py:320-354)."""

    def collect_samples(self):
        img_dir = "image_2"
        assert (self.root / img_dir).is_dir()
        samples = []
        seen = set()
        for filename in sorted((self.root / img_dir).glob("*.png")):
            root_filename = filename.name[:-7]
            if root_filename in seen:
                continue
            seen.add(root_filename)
            img_list = sorted((self.root / img_dir).glob(f"{root_filename}*.png"))
            for st in range(0, len(img_list) - self.n_frames + 1):
                seq = img_list[st : st + self.n_frames]
                samples.append(
                    {"imgs": [p.relative_to(self.root) for p in seq]}
                )
        return samples


class KITTIFlow(ImgSeqDataset):
    """KITTI 2012/2015 with flow_occ + flow_noc GT (flow_datasets.py:356-403)."""

    def __init__(self, root, n_frames=2, split="train", with_flow=True,
                 geometric_transform=None, photometric_transform=None):
        self.with_flow = with_flow
        self.first_level = Path("training" if split == "train" else "testing")
        super().__init__(root, n_frames, geometric_transform, photometric_transform)

    def collect_samples(self):
        flow_occ_dir = self.first_level / "flow_occ"
        flow_noc_dir = self.first_level / "flow_noc"
        img_dir = self.first_level / "image_2"
        if not (self.root / img_dir).is_dir():
            img_dir = self.first_level / "colored_0"
        assert (self.root / img_dir).is_dir()

        samples = []
        for img in sorted((self.root / img_dir).glob("*_10.png")):
            root_filename = img.name[:-7]
            s = {}
            if self.with_flow:
                s["flow_occ"] = flow_occ_dir / img.name
                s["flow_noc"] = flow_noc_dir / img.name
            img1 = img_dir / f"{root_filename}_10.png"
            img2 = img_dir / f"{root_filename}_11.png"
            assert (self.root / img1).is_file() and (self.root / img2).is_file()
            imgs = [img1, img2]
            if self.n_frames == 3:
                img0 = img_dir / f"{root_filename}_09.png"
                assert (self.root / img0).is_file()
                imgs = [img0] + imgs
            s["imgs"] = imgs
            samples.append(s)
        return samples


class Things3D(ImgSeqDataset):
    """FlyingThings3D, unsupervised (flow_datasets.py:406-433)."""

    def __init__(self, root, n_frames=2, split="train", with_flow=False,
                 geometric_transform=None, photometric_transform=None):
        if with_flow:
            raise NotImplementedError("Things3D with_flow")
        self.first_level = Path("TRAIN" if split == "train" else "TEST")
        super().__init__(root, n_frames, geometric_transform, photometric_transform)

    def collect_samples(self):
        if self.n_frames > 2:
            raise NotImplementedError(f"n_frames {self.n_frames}")
        samples = []
        for scene in sorted((self.root / self.first_level).glob("*/*")):
            images = sorted(scene.glob("left/*.png"))
            for i in range(len(images) - 1):
                s = {
                    "imgs": [
                        images[i].relative_to(self.root),
                        images[i + 1].relative_to(self.root),
                    ]
                }
                samples.append(s)
        return samples
