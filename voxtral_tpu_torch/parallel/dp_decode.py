"""Data-parallel decode through K1 (port of
``voxtral_tpu/parallel/dp_decode.py``).

Decode is bound by the weight stream, so the axis that scales serving
throughput is data parallelism: the batch rows split over the mesh's
``data`` axis, each data group holds the whole model and streams its own
copy, and a step needs no collective at all.  Each group runs the whole
stack step (K1, ``ops/decode_step.py::decode_stack_step``) on its rows;
``lm_argmax`` (K1 mode (i)) returns each row's greedy token without
writing the logits.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from voxtral_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, row_groups


def _on(t, d: int, dev: torch.device):
    """Data group ``d``'s copy of a replicated operand: the list's entry
    when one copy per group is given (a tensor, or a tuple of segments),
    else ``t`` moved to ``dev`` (itself where it already lies there), a
    tuple of segments (mode (g)'s qkv and w13) segment by segment."""
    if t is None:
        return None
    if isinstance(t, list):
        return t[d]
    if isinstance(t, tuple):
        return tuple(seg.to(dev) for seg in t)
    return t.to(dev)


def dp_decode_stack_step(
    mesh: Mesh, x, offsets,
    attn_norms, ffn_norms, ada_vecs,
    sqkv, so, s13, s2, cos_b, sin_b,
    k_cache: Sequence[torch.Tensor], v_cache: Sequence[torch.Tensor],
    wqkv, wo, w13, w2,
    final_norm=None, lm_codes=None, lm_scale=None,
    k_scales: Optional[Sequence[torch.Tensor]] = None,
    v_scales: Optional[Sequence[torch.Tensor]] = None,
    *, n_heads: int, n_kv: int, head_dim: int, eps: float,
    window: Optional[int] = None, ring=None, lm_argmax: bool = False,
    cache_chunk: Optional[int] = None, spec: int = 1, step=None,
):
    """``decode_stack_step`` with the batch rows split over ``data``.

    ``x`` [B, D] (B = streams x ``spec`` rows, ordered (stream, draft
    slot)), ``offsets`` an int or [streams] int32, ``cos_b`` / ``sin_b``
    [hd] or per row [B, hd]: split by rows, each data group taking whole
    streams (ValueError, JAX's, when the data axis does not divide the
    streams) and its block moved to its device (``mesh.devices[d][0]``).
    ``k_cache`` / ``v_cache`` (and ``k_scales`` / ``v_scales``): one
    tensor per data group, [L, streams / dp, Hkv, S, hd] on its device,
    where the group's cache lives (the JAX caller passes one array the
    partitioner splits; a row slice of a torch cache is not contiguous).
    Weights, norms, scales and the lm table are replicated: a tensor or a
    tuple of segments (moved to each group's device, a no-op on a shared
    card) or a list with one copy per group.  ``step``: K1's wrapper
    (default) or its plain version.  Zero collectives.

    Returns (x_out [B, D] on x's device, k_new, v_new: one [L, B_d, Hkv,
    hd] per data group on its device, for the caller's appends[, logits
    [B, V] or, with ``lm_argmax``, tokens [B, 1] int32, on x's device]).
    """
    from voxtral_tpu_torch.ops.decode_step import decode_stack_step

    step = step or decode_stack_step
    ndp = mesh.shape[DATA_AXIS]
    B = x.shape[0]
    if spec < 1 or B % spec:
        raise ValueError(
            f"rows {B} (= streams x spec {spec}) must split into whole "
            f"streams per shard over the data axis {ndp}")
    groups = row_groups(B // spec, ndp, spec)
    if len(k_cache) != ndp or len(v_cache) != ndp:
        raise ValueError(f"one cache per data group: {ndp} expected, got "
                         f"{len(k_cache)} / {len(v_cache)}")
    outs = []
    for d, rows in enumerate(groups):
        dev = mesh.devices[d][0]
        streams = slice(rows.start // spec, rows.stop // spec)
        offs = (offsets[streams].to(dev) if isinstance(offsets, torch.Tensor)
                else offsets)
        c, s = ((cos_b[rows].to(dev), sin_b[rows].to(dev))
                if cos_b.dim() == 2 else (cos_b.to(dev), sin_b.to(dev)))
        outs.append(step(
            x[rows].to(dev), offs, _on(attn_norms, d, dev),
            _on(ffn_norms, d, dev), _on(ada_vecs, d, dev),
            _on(sqkv, d, dev), _on(so, d, dev), _on(s13, d, dev),
            _on(s2, d, dev), c, s, k_cache[d], v_cache[d],
            _on(wqkv, d, dev), _on(wo, d, dev), _on(w13, d, dev),
            _on(w2, d, dev), _on(final_norm, d, dev), _on(lm_codes, d, dev),
            _on(lm_scale, d, dev),
            None if k_scales is None else k_scales[d],
            None if v_scales is None else v_scales[d],
            n_heads=n_heads, n_kv=n_kv, head_dim=head_dim, eps=eps,
            window=window, ring=ring, cache_chunk=cache_chunk, spec=spec,
            lm_argmax=lm_argmax))
    home = x.device
    x_out = torch.cat([o[0].to(home) for o in outs])
    result = (x_out, [o[1] for o in outs], [o[2] for o in outs])
    if len(outs[0]) == 4:
        result += (torch.cat([o[3].to(home) for o in outs]),)
    return result
