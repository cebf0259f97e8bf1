"""Performance switches of the model code: the optimised routes and their
baselines.

Port of the JAX package's ``models/opt_flags.py``: the same eight names and
defaults.  Every flag defaults to the optimised route; ``set_baseline()``
turns every flag off (the paper-faithful first implementation) and
``set_opt()`` restores the defaults.  ``launch/dryrun.py --variant`` records
the two side by side.  :data:`FLAGS` is one process-wide dict, read at call
time by the sites below; ``models.layers.FLAGS`` is the same object.

* ``flash_custom_vjp`` — training attention through the hand-written
  backward (``layers._FlashAttention``, scores recomputed chunk by chunk);
  off, autograd runs through the chunked forward and keeps every chunk's
  scores and probabilities for the backward.
* ``decode_direct`` — decode attends over the whole cache at once
  (``layers._direct_attend``); off, the flash-chunked attend of prefill,
  one query row, KV chunks of ``min(512, max_len)``.
* ``attn_bf16_probs`` — the flash attention's probabilities and V enter
  the AV product (and the backward's products) rounded to bf16, fp32
  accumulation; off, fp32.
* ``xent_lse`` — cross-entropy as an fp32 logsumexp minus the label's
  logit; off, an fp32 ``log_softmax`` over the vocabulary.
* ``attn_seq_shard`` — on a mesh whose ``model`` axis the heads do not
  both divide, prefill attention splits the queries over ``model``
  (``layers._maybe_seq_sharded_attention``); off, every rank attends every
  query.
* ``ssd_small_chunk`` — default off; on, the SSD forward runs in chunks of
  ``min(64, ssm_chunk)`` (the reference found it slower, and keeps it off).
* ``moe_sort_positions`` — an assignment's place in its expert by a stable
  sort; off, by the one-hot cumulative count.  Both give the same places.
* ``moe_shard_capacity`` — default off.  In the reference it shards the
  dispatch buffers over (experts x data) and, to make the capacity dim
  divide, rounds the capacity up to a multiple of 256 with 256 dump slots.
  The port's expert parallelism (ROADMAP.md A12) splits the experts over
  ``model`` and keeps each rank's own token slots, never the capacity over
  ``data``, so on it keeps only the capacity rounding: results are bitwise
  those of the flag off wherever no assignment overflows either capacity,
  and otherwise the larger capacity drops fewer assignments, as in the
  reference.
"""

from __future__ import annotations

__all__ = ["FLAGS", "set_baseline", "set_opt"]

FLAGS = {
    "flash_custom_vjp": True,
    "decode_direct": True,
    "attn_bf16_probs": True,
    "xent_lse": True,
    "attn_seq_shard": True,
    "ssd_small_chunk": False,
    "moe_sort_positions": True,
    "moe_shard_capacity": False,
}

_OPT_PROFILE = dict(FLAGS)


def set_baseline() -> None:
    """Every flag off: the baseline routes."""
    for k in FLAGS:
        FLAGS[k] = False


def set_opt() -> None:
    """Every flag back to its default, the optimised routes."""
    FLAGS.update(_OPT_PROFILE)
