"""Plain version of the wave engine's Stage-4 store rewrite.

Counterpart of ``repro/dqueue/wave_engine.py:ring_commit``, which is plain
``jnp`` and has no Pallas kernel; the reference runs it per shard inside
``shard_map``, here every local destination shard is one row of the
leading dimension.  The request rows carry ``slot ‖ tag ‖ payload`` with
the tags of ``core/wave_tags.py``.
"""
from __future__ import annotations

import torch

from ...core.wave_tags import TAG_GET, TAG_PUT


def ring_commit_ref(store, recv, junk: int, W: int):
    """Stage-4 store rewrite for the dense sharded ring, in place.

    store: (store_vals [n, junk+1, W], store_full [n, junk+1]); recv:
    ``[n_dst, n_src, L, 2+W]`` rows ``slot ‖ tag ‖ payload``.  Applies PUTs
    before GETs (a same-wave ENQ is visible to a DEQ), removes on read, and
    routes every inactive row to the ``junk`` slot, whose value is garbage
    and whose full bit stays False.  Returns (store, reply ``[n_dst, n_src,
    L, 1+W]`` ``ok ‖ value``, commit-time overflow = False).
    """
    sv, sf = store
    n = sv.shape[0]
    svf, sff = sv.view(-1, W), sf.view(-1)
    base = (torch.arange(n, device=sv.device) * (junk + 1)).view(n, 1, 1)
    r_slot, r_tag, r_vals = recv[..., 0], recv[..., 1], recv[..., 2:]
    put = (base + torch.where(r_tag == TAG_PUT, r_slot, junk)).reshape(-1)
    svf[put] = r_vals.reshape(-1, W)                 # junk row eats
    # index_fill_, not ``sff[put] = True``: a Python scalar set through a
    # tensor index is copied to the device from the host, a host sync
    sff.index_fill_(0, put, True)
    sf[:, junk] = False
    is_get = r_tag == TAG_GET
    get_slot = torch.where(is_get, r_slot, junk)
    get = base + get_slot                            # [n, n, L]
    res_vals = svf[get]                              # [n, n, L, W]
    res_ok = is_get & sff[get] & (get_slot < junk)
    sff.index_fill_(0, get.reshape(-1), False)       # remove on read
    sf[:, junk] = False
    reply = torch.cat([res_ok.to(torch.int32)[..., None], res_vals], -1)
    return (sv, sf), reply, torch.zeros((), dtype=torch.bool,
                                        device=sv.device)
