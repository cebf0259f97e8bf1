"""Shared serving-metric definitions (port of the JAX package's
``serve/metrics.py``).

Decode throughput is tokens *accepted* — delivered to the caller — divided
by decode wall time.  Without speculative decoding every decoded token is
accepted; speculative decoding proposes more tokens than it delivers, and
the rejected drafts never count.
"""

from __future__ import annotations

__all__ = ["tok_per_s", "acceptance_rate"]


def tok_per_s(accepted_tokens: int, decode_s: float) -> float:
    """Accepted tokens per decode wall second.  ``accepted_tokens`` counts
    tokens delivered beyond the first (prefill-billed) one; ``decode_s`` is
    decode wall time only."""
    return accepted_tokens / max(decode_s, 1e-9)


def acceptance_rate(accepted_drafts: int, proposed_drafts: int) -> float:
    """Fraction of drafter-proposed tokens the verifier accepted; NaN when
    nothing was proposed (a run without drafts reads neither 0 % nor
    100 %)."""
    return accepted_drafts / proposed_drafts if proposed_drafts else float("nan")
