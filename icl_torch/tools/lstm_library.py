"""cuDNN's LSTM beside the port's LSTM layer, at the recurrence kernel's
shapes: the library yardstick of ``csrc/lstm_recurrence.cu`` in f32.

The port's ``LSTM`` and ``BiLSTM`` (``icl_torch/models/rnn.py``) build
every step mask from ``lengths``, so each mask is a prefix, and the
backward copy is the whole padded sequence reversed, its pads first,
where they carry the zero state.  So at every valid position, and for
the final state, the layer computes what one call of ``torch.nn.LSTM``
computes over a packed batch: cuDNN's input GEMM and recurrence, gate
order i, f, g, o (Keras's i, f, c~, o), with ``weight_ih = kernel.T``,
``weight_hh = recurrent_kernel.T``, ``bias_ih = bias`` and ``bias_hh =
0``.  This script times that call, the ``PackedSequence`` built outside
the timed region, beside the port's layer: its input GEMM plus the
recurrence kernel (the layer's own lines, on tensors prepared outside the
timed region), the kernel alone, and the whole module forward.  f32, with
TF32 off in cuBLAS and cuDNN.  With the weights requiring grad, cuDNN
writes its reserve and the kernel its residuals.  Lengths are drawn in
1..L from ``--seed``, the same for both; the two outputs are held to each
other at the valid positions and the final states (max |d| printed).

A GPU tool.  Run by its path, so that ``icl_torch`` comes from
``PYTHONPATH`` (as ``kernel_bits.py``), it times that tree's layer::

    PYTHONPATH=. python icl_torch/tools/lstm_library.py [--seed N]

One JSON line a shape: device ms (profiler) of the library call, of the
port's GEMM + kernel, of the kernel alone and of the module forward, and
the card.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

EMB = 300           # the word vectors the caption and phrase LSTMs read
SHAPES = (          # (name, directions G, L, B, H, weights requiring grad)
    ("BiLSTM L=32 B=64 H=200", 2, 32, 64, 200, False),     # K4 row
    ("LSTM L=16 B=1024 H=200", 1, 16, 1024, 200, False),   # K3 row
    ("BiLSTM L=32 B=512 H=200, grad", 2, 32, 512, 200, True),
    ("LSTM L=16 B=1024 H=200, grad", 1, 16, 1024, 200, True),
    ("BiLSTM L=32 B=64 H=300", 2, 32, 64, 300, False),
    ("BiLSTM L=32 B=64 H=512", 2, 32, 64, 512, False))


def pair(G: int, L: int, B: int, H: int, grad: bool, gen: torch.Generator,
         dev: torch.device) -> dict:
    """The port's layer and an ``nn.LSTM`` with the same weights, inputs
    x [B, L, EMB] and lengths in 1..L from ``gen``, and the calls to time."""
    from torch.nn.utils.rnn import pack_padded_sequence

    from icl_torch.models.rnn import LSTM, BiLSTM

    port = (BiLSTM(EMB, H, device=dev) if G == 2 else LSTM(EMB, H, device=dev))
    lib = torch.nn.LSTM(EMB, H, batch_first=True, bidirectional=G == 2,
                        device=dev)
    dirs = (port.fwd, port.bwd) if G == 2 else (port,)
    with torch.no_grad():
        for d, p in enumerate(dirs):
            sfx = "_reverse" if d else ""
            p.kernel.copy_(torch.randn(EMB, 4 * H, generator=gen) / EMB ** .5)
            p.recurrent_kernel.copy_(torch.randn(H, 4 * H, generator=gen)
                                     / H ** .5)
            p.bias.copy_(torch.randn(4 * H, generator=gen) * 0.1)
            getattr(lib, "weight_ih_l0" + sfx).copy_(p.kernel.T)
            getattr(lib, "weight_hh_l0" + sfx).copy_(p.recurrent_kernel.T)
            getattr(lib, "bias_ih_l0" + sfx).copy_(p.bias)
            getattr(lib, "bias_hh_l0" + sfx).zero_()
    for prm in (*port.parameters(), *lib.parameters()):
        prm.requires_grad_(grad)
    x = torch.randn(B, L, EMB, generator=gen).to(dev)
    lengths = torch.randint(1, L + 1, (B,), generator=gen)
    packed = pack_padded_sequence(x, lengths, batch_first=True,
                                  enforce_sorted=False)
    lengths = lengths.to(dev)
    # the layer's input GEMM and recurrence (rnn.py, BiLSTM.forward and
    # LSTM.forward), their operands prepared outside the timed region
    t = torch.arange(L, device=dev)
    xt = x.transpose(0, 1)                                    # [L, B, D]
    if G == 2:
        xs2 = torch.stack([xt, xt.flip(0)]).reshape(2, L * B, EMB)
        K2 = torch.stack([port.fwd.kernel, port.bwd.kernel])
        b2 = torch.stack([port.fwd.bias, port.bwd.bias])
        R = torch.stack([port.fwd.recurrent_kernel,
                         port.bwd.recurrent_kernel])
        mask = torch.stack([t[:, None] < lengths[None, :],
                            (L - 1 - t)[:, None] < lengths[None, :]])

        def project():
            return (torch.bmm(xs2, K2) + b2[:, None, :]).reshape(2, L, B, -1)
    else:
        K, b = port.kernel, port.bias
        R = port.recurrent_kernel[None]
        mask = (t[:, None] < lengths[None, :])[None]

        def project():
            return (xt @ K + b)[None]
    x_proj = project()

    def core():
        return port.recurrence(project(), mask, R)

    return {"port": port, "lib": lib, "x": x, "lengths": lengths,
            "packed": packed,
            "library": lambda: lib(packed),
            "core": core,
            "kernel": lambda: port.recurrence(x_proj, mask, R),
            "module": lambda: port(x, lengths)}


def agreement(case: dict) -> float:
    """max |cuDNN - the port's layer| over the valid positions of the
    output and the final states."""
    from torch.nn.utils.rnn import pad_packed_sequence

    x, lengths = case["x"], case["lengths"]
    B, L, _ = x.shape
    with torch.no_grad():
        out, (h_n, _) = case["lib"](case["packed"])
        seq, final = case["port"](x, lengths)
    out = pad_packed_sequence(out, batch_first=True, total_length=L)[0]
    valid = (torch.arange(L, device=x.device)[None, :]
             < lengths[:, None])[..., None]
    seq_d = ((out - seq).abs() * valid).max()
    fin_d = (h_n.permute(1, 0, 2).reshape(B, -1) - final).abs().max()
    return float(max(seq_d, fin_d))


def measure(dev: torch.device, seed: int = 0, shapes=SHAPES) -> list:
    """[{shape, library_ms, layer_ms (GEMM + kernel), kernel_ms,
    module_ms, max_abs_diff}] of each shape, device ms a call."""
    from icl_torch.tools.kernel_bits import device_ms

    gen = torch.Generator().manual_seed(seed)
    out = []
    for name, G, L, B, H, grad in shapes:
        case = pair(G, L, B, H, grad, gen, dev)
        ctx = torch.enable_grad if grad else torch.no_grad
        with ctx():
            times = {k: device_ms(case[k])
                     for k in ("library", "core", "kernel", "module")}
        out.append({"shape": name, "library_ms": times["library"],
                    "layer_ms": times["core"], "kernel_ms": times["kernel"],
                    "module_ms": times["module"],
                    "max_abs_diff": agreement(case)})
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("lstm_library: no CUDA device", file=sys.stderr)
        return 2
    seed = int(argv[argv.index("--seed") + 1]) if "--seed" in argv else 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for row in measure(torch.device("cuda"), seed):
        print(json.dumps({**row, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
