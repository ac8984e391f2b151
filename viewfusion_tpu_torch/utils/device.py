"""The one way host arrays reach the card: :func:`to_device`."""

import numpy as np
import torch


def to_device(tree, device, stream=None):
    """``tree`` (an array, None, or a dict, list or tuple of them) with
    each array on ``device``.  On CUDA a host array (numpy, a read-only
    one copied first, or a CPU tensor) is staged in pinned memory by
    numpy's copy (torch's wakes the intra-op threads, which then spin on
    the host's cores) and sent non-blocking on ``stream`` (the current
    stream if None); the caching host allocator frees the staging buffer
    after the copy has run, so the caller may overwrite its arrays once
    this returns.  A tensor already on the card, or any tensor when
    ``device`` is the CPU, comes back as it is."""
    device = torch.device(device)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_device(v, device, stream) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device, stream) for v in tree)
    if not isinstance(tree, torch.Tensor):
        a = np.ascontiguousarray(tree)
        tree = torch.from_numpy(a if a.flags.writeable else a.copy())
    if device.type != "cuda" or tree.device.type != "cpu":
        return tree
    staged = torch.empty(tree.shape, dtype=tree.dtype, pin_memory=True)
    np.copyto(staged.numpy(), tree.numpy())
    with torch.cuda.stream(stream or torch.cuda.current_stream(device)):
        return staged.to(device, non_blocking=True)
