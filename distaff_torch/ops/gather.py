"""Device row gathers for query openings."""

import torch


def gather_rows_dev(arr, indexes, axis=0):
    """arr's rows at `indexes` along `axis`, gathered on arr's device without
    synchronizing (ops.hostsync.TransferBatch brings them to the host)."""
    idx = torch.as_tensor(list(indexes), dtype=torch.int64).to(arr.device)
    return arr.index_select(axis, idx)
