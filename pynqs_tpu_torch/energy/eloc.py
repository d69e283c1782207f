"""Local energy  E_loc(n) = Σ_m <n|H|m> ψ(m)/ψ(n)  over the connected
singles and doubles.

Counterpart of ``pynqs_tpu/energy/eloc.py`` (``local_energy_simple``,
``local_energy_simple_dedup``, ``local_energy_reduce``,
``local_energy_sample_space``, ``make_local_energy``, ``dedup_eval``,
``reduce_unique_count``).  Ratios are formed in log space from
(log|ψ|, arg ψ) pairs.  The JAX package's one-hot block fetches
(``_sample_tail_cdf_blkloc``, ``_onehot_fetch_i32``) are a TPU
workaround for gathers; here the tail draw is ``torch.searchsorted`` on
the cumulative sum and the selection is a plain gather.  Under a
``mesh`` (``parallel/``) the REDUCE tail's uniforms are drawn for the
rows of every rank and sliced (``parallel.rand_rows``), as the JAX
program draws them for the global batch.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function

from pynqs_tpu_torch.ops import cplx
from pynqs_tpu_torch.ops import onv
from pynqs_tpu_torch.ops.lut import row_keys
from pynqs_tpu_torch.ops.excitation import ExcitationTable, excite_bits
from pynqs_tpu_torch.ops.hamiltonian import comb_hij
from pynqs_tpu_torch.parallel.mesh import rand_rows

__all__ = ["local_energy_simple", "local_energy_simple_dedup", "local_energy_reduce",
           "local_energy_sample_space", "make_local_energy", "sample_tail_cdf", "unique_rows",
           "dedup_eval", "reduce_unique_count"]


def unique_rows(flat_bits: torch.Tensor):
    """(first [U] int64, inverse [N] int64): the first row of each distinct
    determinant of flat_bits [N, sorb], in key order, and each row's
    place among them."""
    packed = onv.pack_bits(flat_bits)
    key = row_keys(packed)
    if key is not None:
        _, inverse = torch.unique(key, return_inverse=True)
    else:
        _, inverse = torch.unique(packed, dim=0, return_inverse=True)
    n_u = int(inverse.max()) + 1 if inverse.numel() else 0
    pos = torch.arange(flat_bits.shape[0], device=flat_bits.device)
    first = torch.full((n_u,), flat_bits.shape[0], dtype=torch.long, device=flat_bits.device)
    return first.scatter_reduce_(0, inverse, pos, "amin"), inverse


@torch.no_grad()
def dedup_eval(log_psi_fn: Callable[[torch.Tensor], torch.Tensor], flat_bits: torch.Tensor,
               n_unique_max: int):
    """log ψ once per distinct row of flat_bits [N, sorb]: returns
    (lp [N, 2], n_unique).  Raises when more than ``n_unique_max`` rows
    are distinct: the cap is the forward's batch budget, kept as it was
    given and never grown (the JAX package turns the overflowed rows to
    NaN instead)."""
    first, inverse = unique_rows(flat_bits)
    n_unique = first.shape[0]
    if n_unique > n_unique_max:
        raise OverflowError(f"dedup_eval: {n_unique} distinct rows exceed n_unique_max = "
                            f"{n_unique_max}")
    return log_psi_fn(flat_bits[first])[inverse], n_unique


def _chunks(n: int, batch: int | None):
    step = n if batch is None or batch >= n else batch
    return [(s, min(s + step, n)) for s in range(0, n, max(step, 1))]


@torch.no_grad()
def local_energy_simple(
    log_psi_fn: Callable[[torch.Tensor], torch.Tensor],
    bits: torch.Tensor,
    tables: tuple,
    table: ExcitationTable,
    *,
    batch: int | None = None,
    hpair=None,
) -> torch.Tensor:
    """E_loc for a batch: bits [B, sorb] -> [B, 2] (Re, Im).

    ``log_psi_fn`` maps rows [N, sorb] to (log|ψ|, arg ψ) [N, 2];
    ``tables`` = (h1e, h2e, diag1, K, J); ``batch`` chunks the samples;
    ``hpair`` is ``comb_hij``'s doubles operand (sector-block tuple,
    dense matrix or None)."""
    out = []
    for s, e in _chunks(bits.shape[0], batch):
        comb, hij = comb_hij(bits[s:e], *tables, hpair, table=table, with_comb=True)
        b, m, sorb = comb.shape
        lp = log_psi_fn(comb.reshape(b * m, sorb)).reshape(b, m, 2)
        r_re, r_im = cplx.ratio_re_im(lp, lp[:, :1])
        h = hij.to(r_re.dtype)
        out.append(torch.stack([(h * r_re).sum(-1), (h * r_im).sum(-1)], -1))
    return torch.cat(out, 0)


@torch.no_grad()
def local_energy_simple_dedup(
    log_psi_fn: Callable[[torch.Tensor], torch.Tensor],
    bits: torch.Tensor,
    tables: tuple,
    table: ExcitationTable,
    *,
    n_unique_max: int,
    hpair=None,
):
    """SIMPLE local energy with ψ evaluated once per distinct connected
    determinant (``dedup_eval``, which raises past ``n_unique_max``).
    Returns (eloc [B, 2], n_unique)."""
    comb, hij = comb_hij(bits, *tables, hpair, table=table, with_comb=True)
    b, m, sorb = comb.shape
    lp, n_unique = dedup_eval(log_psi_fn, comb.reshape(b * m, sorb), n_unique_max)
    lp = lp.reshape(b, m, 2)
    r_re, r_im = cplx.ratio_re_im(lp, lp[:, :1])
    h = hij.to(r_re.dtype)
    return torch.stack([(h * r_re).sum(-1), (h * r_im).sum(-1)], -1), n_unique


@torch.no_grad()
def local_energy_sample_space(
    bits: torch.Tensor,
    log_psi: torch.Tensor,
    lut,
    tables: tuple,
    table: ExcitationTable,
    *,
    batch: int | None = None,
    hpair=None,
) -> torch.Tensor:
    """Sample-space E_loc: ψ(m) only for m inside the sampled set, read
    from ``lut`` (an ``ops.lut.WavefunctionLUT`` over exactly those rows);
    a connected determinant outside it contributes nothing, and no ψ
    forward runs.  ``bits``/``log_psi``: the unique sampled rows and their
    (log|ψ|, arg ψ)."""
    out = []
    for s, e in _chunks(bits.shape[0], batch):
        comb, hij = comb_hij(bits[s:e], *tables, hpair, table=table, with_comb=True)
        b, m, sorb = comb.shape
        vals, found = lut.lookup_packed(onv.pack_bits(comb[:, 1:].reshape(b * (m - 1), sorb)))
        r_re, r_im = cplx.ratio_re_im(vals.reshape(b, m - 1, 2), log_psi[s:e, None, :])
        found = found.reshape(b, m - 1)
        r_re = torch.where(found, r_re, torch.zeros_like(r_re))
        r_im = torch.where(found, r_im, torch.zeros_like(r_im))
        h = hij[:, 1:].to(r_re.dtype)
        out.append(torch.stack([hij[:, 0].to(r_re.dtype) + (h * r_re).sum(-1),
                                (h * r_im).sum(-1)], -1))
    return torch.cat(out, 0)


def make_local_energy(model, table: ExcitationTable, tables: tuple, *, method: str = "simple",
                      batch: int | None = None):
    """The local energy bound to ``model`` (its parameters as they are at
    call time) and a system's tables, through ``model.log_psi``:
    "simple" → eloc(bits); "reduce" → eloc(bits, generator, **kw) with
    ``local_energy_reduce``'s keywords.  "sample_space" depends on the
    sampled set: call ``local_energy_sample_space`` with a lookup table."""

    def fwd(rows):
        return model.log_psi(rows)

    if method == "simple":
        return lambda bits: local_energy_simple(fwd, bits, tables, table, batch=batch)
    if method == "reduce":
        return lambda bits, generator, **kw: local_energy_reduce(
            fwd, bits, tables, table, generator, batch=batch, **kw)
    raise NotImplementedError(f"eloc method {method!r}")


def sample_tail_cdf(
    resid: torch.Tensor, n_stoch: int, generator: torch.Generator, mesh=None
) -> torch.Tensor:
    """Stratified inverse-CDF draws [b, n_stoch] with P(j) ∝ resid[:, j].

    u_s = (s + ξ_s)/n · total; draw = #{j : cumsum_j < u_s}.  Every draw's
    marginal is ∝ resid (unbiased), with less variance than iid draws.
    Under a mesh ξ is this rank's block of the draw for every rank's b
    rows."""
    b, n = resid.shape
    c = torch.cumsum(resid, dim=-1)
    xi = rand_rows(mesh, b, n_stoch, generator=generator, dtype=c.dtype, device=c.device)
    u = (torch.arange(n_stoch, dtype=c.dtype, device=c.device)[None] + xi) / n_stoch * c[:, -1:]
    return torch.clamp(torch.searchsorted(c, u), max=n - 1)


@torch.no_grad()
def local_energy_reduce(
    log_psi_fn: Callable[[torch.Tensor], torch.Tensor],
    bits: torch.Tensor,
    tables: tuple,
    table: ExcitationTable,
    generator: torch.Generator,
    *,
    k_det: int = 256,
    n_stoch: int = 64,
    batch: int | None = None,
    hpair=None,
    topk: str = "exact",
    dedup_unique_max: int | None = None,
    prefix_fwd=None,
    mesh=None,
) -> torch.Tensor:
    """Semi-stochastic screened E_loc (reference ElocMethod.REDUCE).

    The k_det largest |H_nm| terms (``topk="exact"``, or ``"approx"``:
    the JAX package's ``lax.approx_max_k``, an exact top-k off the TPU,
    hence the same set here), or the per-segment winners of a strided
    split into k_det segments (``"segmax"``), are summed exactly; the remaining tail is estimated unbiasedly with
    n_stoch stratified draws ∝ |H_nm|:
        Σ_tail H r ≈ (S/n) Σ_s sign(H_s) r_s,   S = Σ_tail |H|.
    ψ forwards per sample: 1 + k_det + n_stoch.  bits [B, sorb] -> [B, 2].
    ``hpair``: as ``local_energy_simple``.

    ``prefix_fwd``: optional prefix-sharing forward
    (``ops/fused_rnn_prefix.ReducePrefixForward``): ``(parent_bits [b, s],
    child_bits [b, C, s], t_min [b, C]) -> (lp_parent [b, 2], lp_children
    [b, C, 2])`` with a ``t_min_orbitals(orbs)`` method.  When set, the
    deterministic and tail children go through it, each reusing its
    sample's recurrence up to its first changed site; the children, the
    tail draws and the generator's use are the same as without it.

    ``dedup_unique_max``: evaluate ψ once per distinct row of each chunk's
    forward (``dedup_eval``, which raises when a chunk has more distinct
    rows than this); exclusive with ``prefix_fwd``.  The rows, the tail
    draws and the generator's use are the same as without it.

    ``mesh``: the tail's uniforms of each chunk are drawn for that chunk's
    rows on every rank (all ranks hold the same number of rows) and this
    rank's block is kept; over one rank the draws are those without it.

    Each chunk's split into deterministic and tail children, from the
    matrix elements to the children's rows, is the ``torch.profiler``
    range ``eloc.select``.
    """
    if topk not in ("exact", "approx", "segmax"):
        raise ValueError(f"unknown topk {topk!r}")
    if prefix_fwd is not None and dedup_unique_max:
        raise ValueError("prefix_fwd and dedup_unique_max are exclusive")
    ns = table.n_singles
    pos = torch.as_tensor(table.pos, dtype=torch.long, device=bits.device)
    out = []
    for s, e in _chunks(bits.shape[0], batch):
        chunk = bits[s:e]
        _, hij = comb_hij(chunk, *tables, hpair, table=table, with_comb=False)
        b, sorb = chunk.shape
        n_off = hij.shape[1] - 1
        kd = min(k_det, n_off)
        with record_function("eloc.select"):
            hij_off = hij[:, 1:]
            absh = hij_off.abs()
            orbs_all = onv.merged_orbital_list(chunk, table.noa, table.nob)[:, pos]

            if topk == "segmax":
                # element j belongs to segment j % kd; the deterministic set
                # is each segment's first maximum (any deterministic set keeps
                # the estimator unbiased: the tail covers what remains)
                L = -(-n_off // kd)
                a2 = torch.nn.functional.pad(absh, (0, kd * L - n_off)).reshape(b, L, kd)
                loc = torch.argmax(a2, dim=1)  # first maximum along the stride
                top_idx = torch.clamp(
                    loc * kd + torch.arange(kd, device=bits.device)[None], max=n_off - 1
                )
            else:
                top_idx = torch.topk(absh, kd, dim=1).indices
            resid = absh.scatter(1, top_idx, 0.0)
            det_h = torch.gather(hij_off, 1, top_idx)
            det_orbs = torch.gather(orbs_all, 1, top_idx[..., None].expand(b, kd, 4))
            det_bits = excite_bits(chunk, det_orbs, top_idx >= ns)

            s_tail = resid.sum(-1)
            draw = sample_tail_cdf(resid, n_stoch, generator, mesh)
            st_h = torch.gather(hij_off, 1, draw)
            st_orbs = torch.gather(orbs_all, 1, draw[..., None].expand(b, n_stoch, 4))
            st_bits = excite_bits(chunk, st_orbs, draw >= ns)

        if prefix_fwd is not None:
            kids = torch.cat([det_bits, st_bits], 1)
            t_min = torch.cat(
                [prefix_fwd.t_min_orbitals(det_orbs), prefix_fwd.t_min_orbitals(st_orbs)], 1
            )
            lp_p, lp_c = prefix_fwd(chunk, kids, t_min)
            lp = torch.cat([lp_p[:, None, :], lp_c], 1)
        else:
            flat = torch.cat([chunk.to(torch.int8)[:, None, :], det_bits, st_bits], 1)
            flat = flat.reshape(-1, sorb)
            if dedup_unique_max:
                lp = dedup_eval(log_psi_fn, flat, dedup_unique_max)[0]
            else:
                lp = log_psi_fn(flat)
            lp = lp.reshape(b, 1 + kd + n_stoch, 2)
        r_re, r_im = cplx.ratio_re_im(lp, lp[:, :1])
        dt = r_re.dtype
        det_hr = det_h.to(dt)
        e_det_re = (det_hr * r_re[:, 1 : 1 + kd]).sum(-1)
        e_det_im = (det_hr * r_im[:, 1 : 1 + kd]).sum(-1)
        sgn = torch.sign(st_h).to(dt)
        scale = torch.where(s_tail > 0, s_tail.to(dt) / n_stoch, torch.zeros_like(s_tail, dtype=dt))
        e_tail_re = scale * (sgn * r_re[:, 1 + kd :]).sum(-1)
        e_tail_im = scale * (sgn * r_im[:, 1 + kd :]).sum(-1)
        out.append(
            torch.stack([hij[:, 0].to(dt) + e_det_re + e_tail_re, e_det_im + e_tail_im], -1)
        )
    return torch.cat(out, 0)


def reduce_unique_count(bits: torch.Tensor, tables: tuple, table: ExcitationTable,
                        generator: torch.Generator, **kw) -> list[int]:
    """The distinct forward rows of each chunk of ``local_energy_reduce``
    (``kw``: its keywords, ``batch`` the chunk): what ``dedup_unique_max``
    must hold.  No ψ forward runs; the generator draws as the energy's."""
    counts = []

    def spy(rows):
        counts.append(unique_rows(rows)[0].shape[0])
        return torch.zeros(rows.shape[0], 2, device=rows.device)

    local_energy_reduce(spy, bits, tables, table, generator, **kw)
    return counts
