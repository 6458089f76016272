"""The three array primitives the fluid and controller kernels share.

Everything else the kernels need is plain ``torch``; these are the
operations whose form is worth fixing in one place:

  * :meth:`TorchOps.count_by_chunk` — integer counts per chunk slot;
  * :meth:`TorchOps.chunk_scatter_add` — ``scatter_add`` into per-chunk
    slots (on the CPU it accumulates in (row, channel) order, the order
    of the NumPy reference's ``np.add.at``; on the card the adds are
    atomics, so the last bit of a sum may vary between runs);
  * :meth:`TorchOps.table_lookup` — per-row ``gather`` from small tables.
"""
from __future__ import annotations

import torch

#: sentinel for a channel slot not assigned to any chunk
NO_CHUNK = -1


class TorchOps:
    """Chunk-slot primitives over a leading batch axis; chunk/channel
    structure on the trailing axes."""

    @staticmethod
    def count_by_chunk(chunk_idx, mask, n_chunks: int):
        """``out[..., k] = sum_c mask & (idx == k)`` as int64; ``NO_CHUNK``
        entries match no chunk."""
        ks = torch.arange(n_chunks, dtype=torch.int64, device=chunk_idx.device)
        onehot = (chunk_idx.unsqueeze(-1) == ks) & mask.unsqueeze(-1)
        return onehot.sum(dim=-2)

    @staticmethod
    def chunk_scatter_add(target, chunk_idx, values, mask):
        """``target[..., idx[..., c]] += values[..., c]`` where ``mask``;
        returns a new tensor. Masked-out entries add ``0.0`` to slot 0,
        which leaves every value as it was."""
        idx = torch.where(mask, chunk_idx, 0)
        vals = torch.where(mask, values, 0.0)
        return target.scatter_add(-1, idx, vals)

    @staticmethod
    def table_lookup(table, idx):
        """``out[..., c] = table[..., idx[..., c]]``; ``idx`` already in
        range."""
        return torch.gather(table, -1, idx)
