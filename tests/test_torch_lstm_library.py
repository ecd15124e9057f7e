"""The library yardstick of the recurrence kernel, on the CPU:
``icl_torch/tools/lstm_library.py`` times one ``torch.nn.LSTM`` call over
a packed batch beside the port's LSTM layer.  That is a yardstick only if
the two compute the same function; this holds them to each other at every
valid position and the final states (the CPU's nn.LSTM and the layer's
plain recurrence), in both directions, with and without gradients."""

import pytest
import torch

from icl_torch.tools import lstm_library


@pytest.mark.parametrize("G,L,B,H,grad", [
    (2, 5, 7, 16, False), (1, 4, 9, 8, True), (2, 6, 3, 12, True),
    (1, 7, 1, 5, False)])
def test_cudnns_lstm_over_a_packed_batch_is_the_ports_layer(G, L, B, H, grad):
    gen = torch.Generator().manual_seed(G * 100 + L * 10 + B)
    case = lstm_library.pair(G, L, B, H, grad, gen, torch.device("cpu"))
    assert case["lengths"].min() >= 1 and case["lengths"].max() <= L
    assert lstm_library.agreement(case) <= 1e-6
    with torch.enable_grad() if grad else torch.no_grad():
        hs, final = case["core"]()
        seq, _ = case["module"]()
    assert hs.requires_grad == grad            # the kernel keeps residuals
    assert hs.shape == (G, L, B, H) and seq.shape == (B, L, G * H)
    want = seq[..., :H].transpose(0, 1)        # the forward direction
    assert torch.equal(hs[0], want)
