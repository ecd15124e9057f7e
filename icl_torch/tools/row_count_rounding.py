"""How far a relation train step's gradients move when the SAME images are
fed in calls of other row counts, on the GPU.

A rank of a data-parallel run feeds half the rows one process feeds.  cuBLAS
picks its kernel by the row count, so the head's projections ``X``, ``Y``
of one and the same image come out with other last bits; a ReLU input that
close to zero then switches, and a gradient that should differ by rounding
differs by a part in a hundred.  This tool shows it without any rank: one
process, one model, one batch of the planted split ``chip_smoke.py``
trains on (64 rows, some of them padding), at dropout 0 and 0.5, plain
path (no hand-written kernel is involved):

* the projections of the real rows, computed in the whole 64-row call and
  in a call of the real rows alone: max |d|, and how many ReLU decisions
  of the weighted cells differ (with |z| at those);
* the gradients of the grid loss under several groupings of the rows (the
  real rows alone, two halves, the halves without padding, quarters, one
  image a call), each block's loss over the global weight sum, against the
  whole batch in one call: the worst gap relative to the tensor's largest
  entry.

Usage, on a machine with an NVIDIA GPU (``main("cpu")`` runs the same on
the CPU, where a row rounds the same in any call)::

    python -m icl_torch.tools.row_count_rounding
"""

from __future__ import annotations

import subprocess
import tempfile

import torch

from icl_torch.data.embeddings import EmbeddingStore
from icl_torch.data.imagebatch import RelationBatcher
from icl_torch.data.pipeline import load_relation_dataset
from icl_torch.models.relation import RelationModel, gather_mention_reps
from icl_torch.testing.synth import SynthConfig, generate_dataset
from icl_torch.train.state import create_train_state
from icl_torch.train.steps import _cell_weights, relation_loss

DIMS = {"emb_dim": 300, "lstm_hidden": 200, "head_hidden": 800}
CLASS_WEIGHTS = [0.3, 1.0, 1.0, 1.0]


def ragged_batch(device: torch.device):
    """(table, batch, real images): the planted 128-image split's batch of
    64 rows that has real images in both halves and padding in the second."""
    with tempfile.TemporaryDirectory(prefix="icl_rounding_") as d:
        generate_dataset(d, "train", SynthConfig(
            planted=True, emb_dim=DIMS["emb_dim"], vocab_size=2000,
            max_caption_len=32, max_mentions_per_caption=3,
            max_boxes_per_image=20, num_images=128, seed=0))
        emb = EmbeddingStore.load(f"{d}/embeddings.txt")
        ds = load_relation_dataset(d, "train", emb)
    batches = [b.arrays for b in RelationBatcher(
        images_per_batch=64, build_grid=True).batches(ds)]
    arrays = next(a for a in batches if 32 < int(a["img_valid"].sum()) < 64)
    batch = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    return (torch.from_numpy(emb.table).to(device), batch,
            int(batch["img_valid"].sum()))


def relu_inputs(model: RelationModel, table, batch):
    """``X``, ``Y`` and the head's ReLU inputs ``z = (X + b1) + Y`` of a
    batch, as the model forms them."""
    tokens = batch["tokens"]
    I, C, L = tokens.shape
    x = table[tokens.reshape(I * C, L).long()]
    enc, _ = model.caption_bilstm(x, batch["tok_len"].reshape(I * C))
    mreps = gather_mention_reps(enc.reshape(I, C, L, -1), batch["m_cap"],
                                batch["m_first"], batch["m_last"])
    R = mreps.shape[-1]
    W1, b1 = model.head_dense.kernel, model.head_dense.bias
    X, Y = mreps @ W1[:R], mreps @ W1[R:]
    return X, Y, (X + b1)[:, :, None, :] + Y[:, None, :, :]


def grads_of(model, state, table, blocks, cw) -> dict:
    """The grid loss's gradients with the batch fed as ``blocks`` (each a
    (batch, seeds) pair), every block's loss over the global weight sum."""
    model.zero_grad(set_to_none=True)
    sums = [_cell_weights(b["grid_label"].to(torch.int32), b["grid_valid"],
                          cw).sum() for b, _ in blocks]
    total = torch.clamp_min(sum(sums), 1.0)
    for (b, seeds), w in zip(blocks, sums):
        loss, _ = relation_loss(model, table, b, seeds, cw, True)
        (loss * torch.clamp_min(w, 1.0) / total).backward()
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def main(device: str = "cuda") -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    card = "the CPU" if dev.type == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    table, batch, n = ragged_batch(dev)
    cw = torch.tensor(CLASS_WEIGHTS, device=dev)
    print(f"{card}; a batch of 64 rows, {n} of them images, f32, TF32 off")
    for dropout in (0.0, 0.5):
        model = RelationModel(**DIMS, fused=False, dropout=dropout,
                              device=dev)
        state = create_train_state(model, seed=0)
        seeds = state.dropout_seeds(64)

        def cut(lo, hi):
            return ({k: v[lo:hi].contiguous() for k, v in batch.items()},
                    seeds[lo:hi])

        if dropout == 0.0:
            with torch.no_grad():
                whole = relu_inputs(model, table, batch)
                real = relu_inputs(model, table, cut(0, n)[0])
            valid = batch["grid_valid"][:n]
            for name, a, b in zip(("X", "Y", "z"), whole, real):
                print(f"{name} of the {n} images, in the 64-row call against "
                      f"the {n}-row call: max|d| "
                      f"{float((a[:n] - b).abs().max()):.3e} (max |{name}| "
                      f"{float(b.abs().max()):.3f})")
            zw, zr = whole[2][:n][valid], real[2][valid]
            flips = (zw > 0) != (zr > 0)
            print(f"ReLU inputs of the weighted cells: {zw.numel()}; "
                  f"decisions that differ between the two calls: "
                  f"{int(flips.sum())}, |z| there "
                  f"{[float(f'{v:.3e}') for v in zw[flips].abs().tolist()]}; "
                  f"share with |z| < 1e-6: "
                  f"{float((zw.abs() < 1e-6).float().mean()):.2e}")
        groupings = {
            "the whole batch again": [cut(0, 64)],
            "the real rows alone": [cut(0, n)],
            "two halves": [cut(0, 32), cut(32, 64)],
            "two halves, the second without its padding":
                [cut(0, 32), cut(32, n)],
            "quarters": [cut(i, i + 16) for i in range(0, 64, 16)],
            "one image a call": [cut(i, i + 1) for i in range(n)]}
        want = grads_of(model, state, table, [cut(0, 64)], cw)
        for name, blocks in groupings.items():
            got = grads_of(model, state, table, blocks, cw)
            gaps = {k: float((want[k] - got[k]).abs().max()
                             / want[k].abs().max()) for k in want}
            worst = max(gaps, key=gaps.get)
            print(f"dropout {dropout}: gradients of {name} against the whole "
                  f"batch in one call: worst gap {gaps[worst]:.3e} of the "
                  f"tensor's largest entry, in {worst}")


if __name__ == "__main__":
    main()
