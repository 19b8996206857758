"""COD dataset discovery and splitting (port of spegnet_tpu/data/dataset.py).

Directory contract: ``{root}/train/{Imgs,GT,Edges}`` and
``{root}/test/{Imgs,GT}``.  Samples are the sorted intersection of the
image / mask (/ edge) basenames.  The train/val split is
torch.utils.data.random_split's with a seed-42 generator, so both packages
train on the same split.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Sample:
    image_path: str
    mask_path: Optional[str] = None
    edge_path: Optional[str] = None
    name: str = ""


@dataclasses.dataclass
class CODDataset:
    samples: List[Sample]
    name: str = ""

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Sample:
        return self.samples[idx]


def discover_samples(root_dir: str, is_train: bool = True) -> CODDataset:
    """A dataset from one split directory ({root}/train or {root}/test)."""
    root = Path(root_dir)
    image_dir, mask_dir, edge_dir = root / "Imgs", root / "GT", root / "Edges"
    if not image_dir.exists() or not mask_dir.exists():
        raise FileNotFoundError(f"Required directories not found in {root_dir}")
    if is_train and not edge_dir.exists():
        raise FileNotFoundError(f"Edge directory not found for training in {root_dir}")

    def stems(d: Path, exts: Tuple[str, ...]) -> dict:
        return {f.split(".")[0]: f for f in os.listdir(d) if f.endswith(exts)}

    images = stems(image_dir, (".jpg", ".png"))
    masks = stems(mask_dir, (".png",))
    valid = set(images) & set(masks)
    edges = {}
    if is_train:
        edges = stems(edge_dir, (".png",))
        valid &= set(edges)
    if not valid:
        raise ValueError(f"No valid samples found in {image_dir}")
    samples = [Sample(image_path=str(image_dir / images[s]), mask_path=str(mask_dir / masks[s]),
                      edge_path=str(edge_dir / edges[s]) if is_train else None, name=s)
               for s in sorted(valid)]
    return CODDataset(samples, name=root.parent.name or root.name)


def concat_train_datasets(dataset_dirs: Sequence[str]) -> CODDataset:
    """All samples of {dir}/train for every root that has one."""
    all_samples: List[Sample] = []
    for d in dataset_dirs:
        train_path = Path(d) / "train"
        if train_path.exists():
            all_samples.extend(discover_samples(str(train_path), is_train=True).samples)
    if not all_samples:
        raise ValueError("No valid training datasets found")
    return CODDataset(all_samples, name="train")


def get_test_datasets(dataset_dirs: Sequence[str]) -> dict:
    """One test dataset per root that has a ``test`` split, keyed by the
    root's basename (``get_test_datasets`` of the JAX package, :92)."""
    out = {}
    for d in dataset_dirs:
        test_path = Path(d) / "test"
        if test_path.exists():
            out[Path(d).name] = discover_samples(str(test_path), is_train=False)
    if not out:
        raise ValueError("No valid test datasets found")
    return out


def train_val_split(dataset: CODDataset, val_ratio: float,
                    seed: int = 42) -> Tuple[CODDataset, Optional[CODDataset]]:
    """random_split(generator=manual_seed(seed)): a seeded randperm, the
    first (1 - r) n indices to train, the rest to val."""
    n = len(dataset)
    if val_ratio <= 0:
        return dataset, None
    train_size = int((1 - val_ratio) * n)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed)).tolist()
    return (CODDataset([dataset.samples[i] for i in perm[:train_size]], "train"),
            CODDataset([dataset.samples[i] for i in perm[train_size:]], "val"))
