"""Synchronising CUDA calls inside the `tick` span (counter
`host_syncs`, torch.cuda's sync debug mode), median per traced tick."""
from portbench import spans


def read(rec):
    return spans.counter("host_syncs")
