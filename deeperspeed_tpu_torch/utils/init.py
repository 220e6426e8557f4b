"""Weight initialisation shared by the model families and the
transformer layer."""

import numpy as np
import torch


def normal_drawer(seed, device):
    """``norm(shape, std)`` drawing fp32 normals on ``device`` from
    ``seed``: an int (seeds a ``torch.Generator`` on ``device``), a
    ``torch.Generator`` on ``device`` (its stream continues from call to
    call), or a numpy ``Generator`` / ``RandomState`` (draws on the host,
    then copies). On the ``meta`` device it draws nothing: the tensors
    have shapes and no storage."""
    if torch.device(device).type == "meta":
        # shapes only (PipelineModule counts a layer's params this way)
        return lambda shape, s: torch.empty(shape, dtype=torch.float32,
                                            device="meta")
    if isinstance(seed, (np.random.Generator, np.random.RandomState)):
        def norm(shape, s):
            a = seed.standard_normal(shape).astype(np.float32) * np.float32(s)
            return torch.from_numpy(a).to(device)
        return norm
    gen = seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(seed))

    def norm(shape, s):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32) * s
    return norm
