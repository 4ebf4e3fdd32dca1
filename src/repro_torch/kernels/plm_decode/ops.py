"""Host bridge: plm/rmi word streams -> one ragged batch -> batched decode.

Parses each stream (postings/plm.py layout), bit-unpacks corrections on the
host, lays the lists end to end with each segment start shifted to its flat
position, decodes the whole batch in one ``decode_batch`` call on ``device``
and splits it back into lists.  No list is padded.  The uint32 stream fields
are reinterpreted as int32 (doc ids < 2^31 by the index contract, enforced
in the host decoder)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.plm_decode.kernel import decode_batch
from repro_torch.postings.plm import parse_stream


def decode_lists(
    streams: list[np.ndarray], lens: list[int], *, device: torch.device | str
) -> list[np.ndarray]:
    """Batched exact decode of many plm/rmi streams -> list of int32 id arrays."""
    nonempty = [i for i, n in enumerate(lens) if n > 0]
    out: list[np.ndarray] = [np.zeros(0, np.int32)] * len(lens)
    if not nonempty:
        return out
    offsets = np.zeros(len(nonempty) + 1, np.int64)
    np.cumsum([lens[i] for i in nonempty], out=offsets[1:])
    if offsets[-1] >= 2**31:
        raise ValueError(f"{offsets[-1]} postings exceed the kernel's int32 positions")
    parsed = [parse_stream(streams[i], lens[i]) for i in nonempty]
    for i, (st, *_) in zip(nonempty, parsed):
        if st[0] != 0:
            raise ValueError(f"stream {i}: first segment starts at rank {st[0]}, not 0")
    seg_pos = np.concatenate([st + off for (st, *_), off in zip(parsed, offsets)])
    bases = np.concatenate([p[1] for p in parsed])
    slopes = np.concatenate([p[2] for p in parsed])
    corr = np.concatenate([p[3] for p in parsed])
    dev = torch.device(device)

    def put(a: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    ids = decode_batch(
        put(seg_pos, np.int32), put(bases, np.int32), put(slopes, np.float32), put(corr, np.int32)
    ).cpu().numpy()
    for row, i in enumerate(nonempty):
        out[i] = ids[offsets[row] : offsets[row + 1]]
    return out
