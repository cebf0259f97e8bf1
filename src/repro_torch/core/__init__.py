"""Host-side pack format and pruning."""
