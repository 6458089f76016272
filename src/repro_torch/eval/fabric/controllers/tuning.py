"""Algorithm 1 (protocol-parameter estimation) and the SC chunk order as
tensor kernels. Integer outputs, float64 intermediate math in the order
of the paper's pseudo-code, so the results are exact."""
from __future__ import annotations

import torch


def optimal_params(avg_file_size, bdp, buffer_size, max_cc, num_files, max_pipelining: int):
    """Algorithm 1, elementwise over broadcast-compatible tensors.

    ``num_files <= 0`` means no file-count cap. Returns int64
    ``(pipelining, parallelism, concurrency)``."""
    avg = avg_file_size.to(torch.float64)
    bdp = bdp.to(torch.float64)
    buf = buffer_size.to(torch.float64)
    mc = max_cc.to(torch.float64)
    nf = num_files.to(torch.int64)

    # line 2: pipelining = BDP / avgFileSize, clamped to a practical depth
    pp = torch.clamp(torch.ceil(bdp / avg), 0.0, float(max_pipelining))
    pp = pp.to(torch.int64)

    # line 3: parallelism = Min(ceil(BDP/buffer), ceil(avgFileSize/buffer))
    par = torch.minimum(torch.ceil(bdp / buf), torch.ceil(avg / buf))
    par = torch.clamp(par, min=1.0).to(torch.int64)

    # line 4: concurrency = Min(Max(BDP/avgFileSize, 2), maxCC)
    cc = torch.minimum(torch.clamp(bdp / avg, min=2.0), mc)
    cc = torch.clamp(torch.floor(cc), min=1.0).to(torch.int64)

    capped = nf > 0
    pp = torch.where(capped, torch.minimum(pp, torch.clamp(nf - 1, min=0)), pp)
    cc = torch.where(capped, torch.minimum(cc, nf), cc)
    return pp, par, cc


def sc_chunk_order(ctypes):
    """SC transfer order over (..., K) integer chunk types: largest size
    class first, stable by index, via a unique composite key."""
    ct = ctypes.to(torch.int64)
    K = ct.shape[-1]
    hi = ct.amax(dim=-1, keepdim=True) if K else ct
    key = (hi - ct) * K + torch.arange(K, dtype=torch.int64, device=ct.device)
    return torch.argsort(key, dim=-1)
