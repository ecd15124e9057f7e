"""Plain PyTorch pieces the references share: float32 with TF32 off, no
kernels, no batching tricks, nothing of the program.

* :func:`lstm`: the Keras LSTM over each row's own tokens (gates i, f, c~, o;
  c = f c + i c~, h = o tanh(c)); past a row's length the state is carried
  through, so ``final`` is the state after the last token.
* :func:`reverse_rows`: each row's first ``length`` positions reversed, so
  an LSTM over it reads the tokens from the last one back.
* :func:`keep_mask`: the per-cell dropout mask the configurations state:
  bits = hash(hash(hash(hash(seed) ^ a) ^ b) ^ k), kept iff bits >=
  round(rate * 2**32), with the 32-bit multiply-xorshift hash.
* :func:`exact_f32`: a context with TF32 off in cuBLAS and cuDNN.
"""

from __future__ import annotations

import contextlib

import torch

_M32 = 0xFFFFFFFF


@contextlib.contextmanager
def exact_f32():
    """float32 products with TF32 off, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def pad_rows(rows: list, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-id arrays -> (int64 [N, T] zero-padded, lengths [N])."""
    lengths = torch.tensor([len(r) for r in rows], dtype=torch.long)
    out = torch.zeros(len(rows), max(int(lengths.max()), 1),
                      dtype=torch.long)
    for n, r in enumerate(rows):
        out[n, :len(r)] = torch.as_tensor(r, dtype=torch.long)
    return out.to(device), lengths.to(device)


def lstm(x: torch.Tensor, lengths: torch.Tensor, W: torch.Tensor,
         R: torch.Tensor, b: torch.Tensor):
    """x [N, T, D] -> (h [N, T, H], final h [N, H])."""
    N, T, _ = x.shape
    H = R.shape[0]
    z_in = x @ W + b
    h = x.new_zeros(N, H)
    c = x.new_zeros(N, H)
    hs = []
    for t in range(T):
        z = z_in[:, t] + h @ R
        i, f, g, o = z.split(H, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        live = (t < lengths)[:, None]
        c = torch.where(live, c_new, c)
        h = torch.where(live, h_new, h)
        hs.append(h)
    return torch.stack(hs, 1), h


def reverse_rows(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """x [N, T, ...]: positions t < length become length - 1 - t."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)
    idx = torch.where(t[None, :] < lengths[:, None],
                      lengths[:, None] - 1 - t[None, :], t[None, :])
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _hash32(x: torch.Tensor) -> torch.Tensor:
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    return (x >> 16) ^ x


def keep_mask(seed: int, a: torch.Tensor, b: torch.Tensor, K: int,
              rate: float) -> torch.Tensor:
    """bool [len(a), K]: the dropout keep bits of cells (a, b) of an image
    whose seed is ``seed``."""
    h = _hash32(torch.full_like(a, int(seed) & _M32))
    h = _hash32(h ^ a)
    h = _hash32(h ^ b)
    k = torch.arange(K, device=a.device, dtype=torch.long)
    thr = min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)
    return _hash32(h[:, None] ^ k[None, :]) >= thr
