"""Host-side numpy: the pack formats, pruning, and the paper's scheduler, growth,
cycle and area/power models and workloads."""
