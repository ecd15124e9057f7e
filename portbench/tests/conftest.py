"""Cells cut to a size the CPU runs in seconds, for the harness's tests.

Every width shrinks; the traffic keeps its kind.  The card's tests take the
cells as ``BENCHMARK.json`` has them."""

from __future__ import annotations

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.lib import cell as cells  # noqa: E402

TINY = {"vocab_size": 50, "emb_dim": 8, "lstm_hidden": 8, "head_hidden": 16}
TINY_TRAFFIC = {"images": 24, "images_per_batch": 4}


def tiny_cell(name: str) -> dict:
    c = cells.load_cell(name)
    cfg = {**c["config"], **TINY}
    if "box_dim" in cfg:
        cfg["box_dim"] = 32
    c["config"] = cfg
    c["traffic"].update({k: v for k, v in TINY_TRAFFIC.items()
                         if k in c["traffic"]})
    return c


def measure(c: dict, seed: int, seconds: float = 0.3, trace: bool = False,
            device="cpu", control: bool = False) -> dict:
    sys.path.insert(0, os.path.join(ROOT, "portbench"))
    import run as pbrun

    return pbrun.measure(c, seed, seconds, trace, torch.device(device),
                         pbrun.T_PROCESS, control=control)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)
