"""Memory-fused softmax cross-entropy over integer labels — the port of
``deeplearning4j_tpu/ops/fused_ce.py``.

The logits stay in their storage dtype (bf16 at training) in both
directions: the forward saves them with the f32 per-row logsumexp, and the
backward emits ``(softmax - onehot) * g`` directly in the logits' dtype, as
the reference's custom VJP does. Reductions and the loss are f32.

XLA fuses the reference's f32 upcast into its reduce loops; eager PyTorch
would materialize it, which at GPT-2-small training (B 24, T 1024, V 50304)
is several 4.9 GB f32 temporaries. Both directions therefore run over chunks
of rows: every row's arithmetic is the same as unchunked, only the peak of
the f32 temporaries is bounded. Not a Pallas kernel in the reference, so
plain PyTorch is the port.
"""

from __future__ import annotations

import torch

#: f32 elements per chunk of rows (512 MiB of f32 temporaries per buffer)
_CHUNK_ELEMS = 1 << 27


def _row_chunks(n_rows: int, vocab: int):
    step = max(1, _CHUNK_ELEMS // max(vocab, 1))
    for r0 in range(0, n_rows, step):
        yield r0, min(r0 + step, n_rows)


class _FusedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, targets):
        v = logits.shape[-1]
        flat = logits.reshape(-1, v)
        tgt = targets.reshape(-1).long()
        ce = torch.empty(flat.shape[0], dtype=torch.float32,
                         device=logits.device)
        lse = torch.empty_like(ce)
        for r0, r1 in _row_chunks(flat.shape[0], v):
            lf = flat[r0:r1].float()
            m = lf.amax(dim=-1)
            lse[r0:r1] = m + torch.log(torch.exp(lf - m[:, None]).sum(dim=-1))
            ce[r0:r1] = lse[r0:r1] - lf.gather(-1, tgt[r0:r1, None])[:, 0]
        ctx.save_for_backward(logits, lse, tgt)
        return ce.reshape(targets.shape)

    @staticmethod
    def backward(ctx, g):
        logits, lse, tgt = ctx.saved_tensors
        v = logits.shape[-1]
        flat = logits.reshape(-1, v)
        g = g.reshape(-1).float()
        dlogits = torch.empty_like(flat)
        for r0, r1 in _row_chunks(flat.shape[0], v):
            p = torch.exp(flat[r0:r1].float() - lse[r0:r1, None])
            # p - onehot: the target column loses exactly 1
            p[torch.arange(r1 - r0, device=p.device), tgt[r0:r1]] -= 1.0
            dlogits[r0:r1] = p * g[r0:r1, None]
        return dlogits.reshape(logits.shape), None


def cross_entropy_with_integer_labels(logits: torch.Tensor,
                                      targets: torch.Tensor) -> torch.Tensor:
    """Per-position CE: logits (..., V) any float dtype, targets (...,) int
    -> (...,) f32. Its gradient comes back in the logits' dtype."""
    return _FusedCE.apply(logits, targets)
