"""Plain reference of the affinity model's predict (ImageCaptionLearn_py's
phrase-box affinity scorer with its box ranking), float32.

Per image: each phrase through an LSTM over its own tokens (200 units), its
final state h; a (phrase a, box b) cell is scored relu(h_a Wp + bp + f_b Wb)
-> W2 + b2 over the 4096-d box features f; probabilities are the softmax
over the 2 classes, and the ranking of a phrase is the softmax of the
affinity logit (class 1) over the image's boxes.
"""

from __future__ import annotations

import torch

from portbench.reference import plain


def predict(p: dict, table: torch.Tensor, images: list[dict],
            boxes) -> list:
    """Each image's (probabilities [M, B, 2], ranking [M, B]) on the host;
    ``boxes`` is the split's box block (host float32 [rows, 4096])."""
    dev = table.device
    with plain.exact_f32(), torch.no_grad():
        phrases = [ph for im in images for ph in im["phrases"]]
        tokens, lengths = plain.pad_rows(phrases, dev)
        _, h = plain.lstm(table[tokens], lengths, p["phrase_lstm/kernel"],
                          p["phrase_lstm/recurrent_kernel"],
                          p["phrase_lstm/bias"])
        X = h @ p["head_dense_phrase/kernel"] + p["head_dense_phrase/bias"]
        W2, b2 = p["head_out/kernel"], p["head_out/bias"]
        out, row = [], 0
        for im in images:
            M = len(im["phrases"])
            f = torch.as_tensor(boxes[im["box_row"]:im["box_row"]
                                      + im["n_boxes"]], device=dev)
            Y = f @ p["head_dense_box/kernel"]
            logits = torch.relu(X[row:row + M, None] + Y[None]) @ W2 + b2
            out.append((torch.softmax(logits, -1).cpu().numpy(),
                        torch.softmax(logits[..., 1], -1).cpu().numpy()))
            row += M
    return out
