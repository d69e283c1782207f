"""Stochastic reconfiguration (natural gradient), pair representation.

Counterpart of ``pynqs_tpu/grad/sr.py``.  With O_k = ∂(u + iv)/∂θ_k =
g_u + i g_v (θ real, log ψ = (u, v) pair):

    Re S = ⟨g_u g_uᵀ + g_v g_vᵀ⟩ − ⟨g_u⟩⟨g_u⟩ᵀ − ⟨g_v⟩⟨g_v⟩ᵀ
    2 Re F = 2 ⟨ (a − ā) g_u + (b − b̄) g_v ⟩          (E_loc = a + ib)
    dθ = (Re S + λI)⁻¹ · 2 Re F

Three solvers, each returning a dict {name: tensor} over the model's
parameters (the JAX package's leaf names):

* ``sr_gradient``: the dense [P, P] solve, from per-row gradients of
  both outputs of ``model.log_psi`` (``torch.func.vmap`` of
  ``jacrev``, in ``jac_batch`` chunks);
* ``sr_gradient_blocked``: one dense solve per parameter block (by
  default one block per tensor; ``blocks`` maps name → label);
* ``sr_gradient_cg``: matrix-free min-SR, plain conjugate gradients
  whose every S·v is one jvp and one vjp through ``model.log_psi``, so
  neither S nor the Jacobian is ever formed.

SR always differentiates ``model.log_psi`` (the fused forward has no
gradient) and runs where the model lives.  A ``torch.func`` transform
that fails raises; there is no other route.

Under a ``mesh`` (``parallel/``) each rank holds its rows, with weights
normalized over all ranks.  CG all-reduces its centring sums (m_c and
F, one collective) and, in every matvec, the Oᵀ(w ∘ O v) sums with the
two w·(O v) channel sums (one collective per matvec); its iterates are
then the same on every rank.  The dense and blocked solvers reduce S:
the weighted mean of O is all-reduced, then each rank's S and F are
summed in one collective, and every rank solves the same system (the
[P, P] sum is P² numbers; gathering O's rows would move [B, 2, P]).
"""

from __future__ import annotations

import torch
from torch.func import functional_call, jacrev, jvp, vjp, vmap

from pynqs_tpu_torch.grad.energy_grad import _centered
from pynqs_tpu_torch.parallel.mesh import all_reduce_sum

__all__ = ["sr_gradient", "sr_gradient_cg", "sr_gradient_blocked", "cg_residual"]


def _params(model) -> dict:
    return {n: p.detach() for n, p in model.named_parameters()}


def _row_jacobian(model, params: dict, bits, jac_batch) -> dict:
    """{name: [B, 2, *shape]}: each row's gradients of (log|ψ|, arg ψ)."""

    def row(p, b):
        return functional_call(model, p, (b[None],))[0]

    per_rows = vmap(jacrev(row), in_dims=(None, 0))
    B = bits.shape[0]
    step = B if jac_batch is None or jac_batch >= B else jac_batch
    parts = [per_rows(params, bits[s:s + step]) for s in range(0, B, step)]
    return {k: torch.cat([p[k] for p in parts]) for k in params}


def _solve_block(O, weights, alive, cen, damping, mesh=None):
    """dθ of one block from its per-row gradients O [B, 2, Pb]."""
    O = torch.where(alive[:, None, None], O, torch.zeros_like(O))
    o_mean = all_reduce_sum(mesh, torch.einsum("n,ncp->cp", weights, O))
    Oc = torch.where(alive[:, None, None], O - o_mean, torch.zeros_like(O))
    S = torch.einsum("n,ncp,ncq->pq", weights, Oc, Oc)
    F = 2.0 * torch.einsum("n,nc,ncp->p", weights, cen, Oc)
    if mesh is not None:
        SF = all_reduce_sum(mesh, torch.cat([S, F[None]], 0))
        S, F = SF[:-1], SF[-1]
    A = S + damping * torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    L = torch.linalg.cholesky(A)
    return torch.cholesky_solve(F[:, None], L)[:, 0]


def sr_gradient(model, bits, weights, eloc, damping: float = 1e-3,
                jac_batch: int | None = None, mesh=None) -> dict:
    """The SR-preconditioned gradient by one dense solve.  bits [B, sorb];
    weights [B] (sum 1; 0 = dead row); eloc [B, 2]."""
    return sr_gradient_blocked(model, bits, weights, eloc, damping,
                               blocks={n: 0 for n, _ in model.named_parameters()},
                               jac_batch=jac_batch, mesh=mesh)


def sr_gradient_blocked(model, bits, weights, eloc, damping: float = 1e-3,
                        blocks: dict | None = None, jac_batch: int | None = None,
                        mesh=None) -> dict:
    """Block-diagonal SR (the K-FAC-family preconditioner): the
    cross-curvature between blocks is dropped and each block's Fisher
    block solved exactly, dθ_b = (Re S_bb + λI)⁻¹ · 2 Re F_b.  One block
    per parameter tensor by default; ``blocks`` maps name → label to
    merge tensors (one label for all gives ``sr_gradient``)."""
    weights, alive, _, cen = _centered(weights, eloc, mesh)
    params = _params(model)
    names = sorted(params)  # the JAX tree's leaf order
    jac = _row_jacobian(model, params, bits, jac_batch)
    B = bits.shape[0]
    groups: dict = {}
    for n in names:
        groups.setdefault(n if blocks is None else blocks.get(n, n), []).append(n)
    out = {}
    for members in groups.values():
        O = torch.cat([jac[n].reshape(B, 2, -1) for n in members], -1)
        d = _solve_block(O, weights, alive, cen, damping, mesh)
        off = 0
        for n in members:
            sz = params[n].numel()
            out[n] = d[off:off + sz].reshape(params[n].shape)
            off += sz
    return {n: out[n] for n in params}


def _cg_system(model, bits, weights, eloc, damping: float, jac_batch: int | None,
               mesh=None):
    """(matvec, F) of (Re S + λ)·δθ = 2 Re F over the parameter dicts.

    With m_c = Σ_n w_n O[n, c, :]:  S v = Σ_c [O_cᵀ (w ∘ O_c v) − m_c (m_cᵀ v)],
    O_c v from one jvp (both channels) and the transposes from one vjp;
    F = Σ_c O_cᵀ (2 w ∘ cen_c) (the centering term vanishes since
    Σ_n w_n cen_n = 0).  Below B, ``jac_batch`` rows at a time: each
    chunk is linearized again inside every matvec, so the saved
    activations scale with the chunk.  Under a mesh the sums over rows
    are all-reduced (``_reduce_dicts``)."""
    weights, alive, _, cen = _centered(weights, eloc, mesh)
    params = _params(model)
    B = bits.shape[0]
    step = B if jac_batch is None or jac_batch >= B else jac_batch
    chunks = [(bits[s:s + step], weights[s:s + step], cen[s:s + step], alive[s:s + step])
              for s in range(0, B, step)]

    def f_of(b, a):
        def f(p):
            lp = functional_call(model, p, (b,))
            return torch.where(a[:, None], lp, torch.zeros_like(lp))
        return f

    def add(acc, d):
        return d if acc is None else {k: acc[k] + d[k] for k in acc}

    def combine(back, mv0, mv1, m0, m1, v):
        return {k: back[k] - mv0 * m0[k] - mv1 * m1[k] + damping * v[k] for k in v}

    def two(w):
        z = torch.zeros_like(w)
        return torch.stack([w, z], -1), torch.stack([z, w], -1)

    if len(chunks) == 1:
        f = f_of(bits, alive)
        _, vjp_fn = vjp(f, params)
        e0, e1 = two(weights)
        m0, m1, F = _reduce_dicts(mesh, [vjp_fn(e0)[0], vjp_fn(e1)[0],
                                         vjp_fn(2.0 * weights[:, None] * cen)[0]])

        def matvec(v):
            _, t = jvp(f, (params,), (v,))
            t = torch.where(alive[:, None], t, torch.zeros_like(t))
            (back,) = vjp_fn(weights[:, None] * t)
            back, mv = _reduce_dicts(mesh, [back, {"0": (weights * t[:, 0]).sum(),
                                                   "1": (weights * t[:, 1]).sum()}])
            return combine(back, mv["0"], mv["1"], m0, m1, v)

        return matvec, F

    m0 = m1 = F = None
    for b, w, c, a in chunks:
        _, vjp_fn = vjp(f_of(b, a), params)
        e0, e1 = two(w)
        m0 = add(m0, vjp_fn(e0)[0])
        m1 = add(m1, vjp_fn(e1)[0])
        F = add(F, vjp_fn(2.0 * w[:, None] * c)[0])
    m0, m1, F = _reduce_dicts(mesh, [m0, m1, F])

    def matvec(v):
        back = None
        mv0 = mv1 = torch.zeros((), dtype=weights.dtype, device=weights.device)
        for b, w, c, a in chunks:
            f = f_of(b, a)
            _, t = jvp(f, (params,), (v,))
            _, vjp_fn = vjp(f, params)
            back = add(back, vjp_fn(w[:, None] * t)[0])
            mv0 = mv0 + (w * t[:, 0]).sum()
            mv1 = mv1 + (w * t[:, 1]).sum()
        back, mv = _reduce_dicts(mesh, [back, {"0": mv0, "1": mv1}])
        return combine(back, mv["0"], mv["1"], m0, m1, v)

    return matvec, F


def _reduce_dicts(mesh, dicts: list) -> list:
    """The dicts of tensors summed over the ranks in one all-reduce (as
    they are without a mesh)."""
    if mesh is None:
        return dicts
    items = [(i, k, t) for i, d in enumerate(dicts) for k, t in d.items()]
    flat = all_reduce_sum(mesh, torch.cat([t.reshape(-1) for _, _, t in items]))
    out = [{} for _ in dicts]
    for (i, k, t), part in zip(items, torch.split(flat, [t.numel() for _, _, t in items])):
        out[i][k] = part.reshape(t.shape).to(t.dtype)
    return out


def _dot(a: dict, b: dict):
    return sum((a[k] * b[k]).sum() for k in sorted(a))


def sr_gradient_cg(model, bits, weights, eloc, damping: float = 1e-3, n_cg: int = 50,
                   jac_batch: int | None = None, mesh=None) -> dict:
    """Matrix-free SR: (Re S + λ)·δθ = 2 Re F by plain conjugate gradients
    from zero, exactly ``n_cg`` iterations with no early exit, the
    denominators floored at 1e-30 (as the JAX ``fori_loop``); every scalar
    stays on the device."""
    matvec, F = _cg_system(model, bits, weights, eloc, damping, jac_batch, mesh)
    x = {k: torch.zeros_like(v) for k, v in F.items()}
    r, p = F, F
    rs = _dot(r, r)
    for _ in range(n_cg):
        Ap = matvec(p)
        alpha = rs / torch.clamp(_dot(p, Ap), min=1e-30)
        x = {k: x[k] + alpha * p[k] for k in x}
        r = {k: r[k] - alpha * Ap[k] for k in r}
        rs_new = _dot(r, r)
        beta = rs_new / torch.clamp(rs, min=1e-30)
        p = {k: r[k] + beta * p[k] for k in r}
        rs = rs_new
    return x


def cg_residual(model, bits, weights, eloc, x: dict, damping: float = 1e-3,
                jac_batch: int | None = None, mesh=None) -> torch.Tensor:
    """‖(Re S + λ)·x − 2 Re F‖ / ‖2 Re F‖ (0-d tensor) by one more matvec: how
    far a CG solution ``x`` is from solving the system."""
    matvec, F = _cg_system(model, bits, weights, eloc, damping, jac_batch, mesh)
    Ax = matvec(x)
    res = {k: Ax[k] - F[k] for k in F}
    return torch.sqrt(_dot(res, res) / torch.clamp(_dot(F, F), min=1e-300))
