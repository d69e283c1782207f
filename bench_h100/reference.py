"""Plain reference of the benchmark's comparisons.

Plain PyTorch and NumPy, written from the published definitions: the
Graph-MPS-RNN forward (arg phase, mpsrnn gauge, optional tensor coupling),
the Slater–Condon matrix elements of an antisymmetrized spin-orbital
Hamiltonian, the semi-stochastic REDUCE local energy, GFMC's fixed-node
Green row and AdamW.  It imports nothing of the program under test and
takes none of its derived tables: integrals, weights and rows come from
the benchmark's inputs or from the program's outputs that it judges.

Conventions: spin orbitals interleaved alpha/beta (even/odd); sites are
spatial orbitals visited in index order; the compressed two-electron
triangle holds <ij||kl> at pair indices ij = i(i-1)/2 + j (i > j) and
position ij(ij+1)/2 + kl (ij >= kl).  The lower-precision control
(``quant="fp8"``) rounds both operands of every matrix product to
float8 e4m3 with a per-tensor scale, the next step below the bf16 products
of the configuration.
"""

from __future__ import annotations

import math
import os
import pickle
import zlib

import numpy as np
import torch

__all__ = ["load_tree", "stand_in_integrals", "seeded_params", "judge_inputs", "Hamiltonian",
           "graph_preds", "log_psi", "reduce_eloc", "selection_faults", "green_row_from",
           "energy_grad", "adamw_steps", "connected"]


# ---------------------------------------------------------------- inputs

class _NumpyOnly(pickle.Unpickler):
    """Unpickles numpy arrays, dicts and scalars only."""

    def find_class(self, module, name):
        if module.split(".")[0] == "numpy" and name in ("ndarray", "dtype", "_reconstruct",
                                                        "scalar"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name} is not allowed in a parameter file")


def load_tree(path: str) -> dict:
    """A flat parameter tree {name: ndarray} from a pickled checkpoint (a
    nested {"params": tree} is unwrapped)."""
    with open(path, "rb") as f:
        tree = _NumpyOnly(f).load()
    return tree["params"] if "params" in tree else tree


def stand_in_integrals(seed: int, sorb: int):
    """Seeded random integrals of a molecule's shape: a symmetric h1e of
    scale 0.1 and a compressed <ij||kl> triangle of scale 0.01."""
    rng = np.random.default_rng(seed)
    h1e = rng.standard_normal((sorb, sorb)) * 0.1
    h1e = (h1e + h1e.T) / 2
    p = sorb * (sorb - 1) // 2
    h2e = rng.standard_normal(p * (p + 1) // 2) * 0.01
    return h1e, h2e


def n_excitations(sorb: int, noa: int, nob: int) -> int:
    """Singles and doubles that keep the alpha and beta counts."""
    c = math.comb
    va, vb = sorb // 2 - noa, sorb // 2 - nob
    return (noa * va + nob * vb + c(noa, 2) * c(va, 2) + c(nob, 2) * c(vb, 2)
            + noa * va * nob * vb)


def judge_inputs(cfg: dict, h1e, h2e, seed: int, root: str, device):
    """(Hamiltonian, predecessors, parameters) of a configuration, from the
    integrals handed to both sides and the weights as the reference loads
    them itself (the checkpoint file, or the seeded draw)."""
    sorb = cfg["sorb"]
    ham = Hamiltonian(h1e, h2e, sorb, cfg["noa"], cfg["nob"], device)
    preds = graph_preds(ham, cfg["max_preds"])
    shapes = param_shapes(sorb // 2, cfg["dcut"], max(len(p) for p in preds) or 1,
                          cfg["use_tensor"], cfg["dcut_cmpr"])
    tree = (load_tree(os.path.join(root, cfg["weights"])) if cfg.get("weights")
            else seeded_params(seed, shapes))
    P = {k: torch.as_tensor(np.asarray(v, np.float32), device=device).reshape(shapes[k])
         for k, v in tree.items()}
    return ham, preds, P


def param_shapes(norb: int, dcut: int, maxp: int, use_tensor: bool, dcut_cmpr: int) -> dict:
    d, dc = dcut, dcut_cmpr
    shapes = {"M_re": (norb, maxp, 4, d, d), "M_im": (norb, maxp, 4, d, d),
              "v_re": (norb, 4, d), "v_im": (norb, 4, d), "eta": (norb, 4, d),
              "global_phase": (), "w_arg_re": (norb, d), "w_arg_im": (norb, d),
              "c_arg_re": (norb,), "c_arg_im": (norb,)}
    if use_tensor:
        shapes.update({"U_re": (norb, maxp, 4, dc, d), "U_im": (norb, maxp, 4, dc, d),
                       "K_re": (norb, 4, d, dc), "K_im": (norb, 4, d, dc)})
    return shapes


def seeded_params(seed: int, shapes: dict) -> dict:
    """Weights of a configuration without a checkpoint, each leaf drawn
    from (seed, its name): M near the identity over its predecessors, the
    rest small normals, eta and the phase offset's real part 1."""
    out = {}
    for k, shp in shapes.items():
        a = np.random.default_rng([seed, zlib.crc32(k.encode())]).standard_normal(shp) * 0.1
        if k == "M_re":
            a = a / math.sqrt(shp[-1] * shp[1]) + np.eye(shp[-1]) / shp[1]
        elif k == "M_im":
            a = a / math.sqrt(shp[-1] * shp[1])
        elif k in ("eta", "c_arg_re"):
            a = np.ones(shp)
        elif k == "global_phase":
            a = np.zeros(shp)
        out[k] = a.astype(np.float32)
    return out


# ---------------------------------------------------------------- Hamiltonian

def _dense_h2e(h2e: np.ndarray, sorb: int) -> np.ndarray:
    i = np.arange(sorb)
    hi, lo = np.maximum(i[:, None], i[None]), np.minimum(i[:, None], i[None])
    pidx = hi * (hi - 1) // 2 + lo
    psgn = np.sign(i[:, None] - i[None]).astype(np.float64)  # 0 on i == j
    a = pidx[:, :, None, None]
    b = pidx[None, None]
    big, small = np.maximum(a, b), np.minimum(a, b)
    pos = np.minimum(big * (big + 1) // 2 + small, h2e.shape[0] - 1)  # i == j: zeroed below
    return h2e[pos] * psgn[:, :, None, None] * psgn[None, None]


class Hamiltonian:
    """<n|H|m> from (h1e [sorb, sorb], compressed h2e) in float64."""

    def __init__(self, h1e, h2e, sorb: int, noa: int, nob: int, device):
        self.sorb, self.noa, self.nob, self.dev = sorb, noa, nob, device
        V = _dense_h2e(np.asarray(h2e, np.float64), sorb)
        self.V = torch.as_tensor(V, device=device)
        self.h1 = torch.as_tensor(np.asarray(h1e, np.float64), device=device)
        # W[a, i, k] = <ak||ik>: the two-electron part of a single i -> a
        self.W = torch.as_tensor(np.einsum("akik->aik", V), device=device)
        self.Vd = torch.as_tensor(np.einsum("ijij->ij", V), device=device)

    def diagonal(self, bits):
        o = bits.double()
        return o @ torch.diagonal(self.h1) + 0.5 * ((o @ self.Vd) * o).sum(-1)

    def between(self, n, m):
        """<n|H|m> for row pairs n, m [N, sorb] (int8); 0 unless m equals n
        or is a single or double excitation of it."""
        n, m = n.long(), m.long()
        holes, parts = n * (1 - m), m * (1 - n)
        nh = holes.sum(-1)
        same_spin = ((holes[:, 0::2].sum(-1) == parts[:, 0::2].sum(-1))
                     & (holes.sum(-1) == parts.sum(-1)))
        below = torch.cumsum(n, -1) - n  # occupied orbitals below each index
        idx = torch.arange(self.sorb, device=n.device)
        # the two lowest holes / particles (the second only for doubles)
        key_h = torch.where(holes > 0, idx, self.sorb)
        key_p = torch.where(parts > 0, idx, self.sorb)
        hi = torch.sort(key_h, -1).values[:, :2].clamp(max=self.sorb - 1)
        pa = torch.sort(key_p, -1).values[:, :2].clamp(max=self.sorb - 1)
        i, j, a, b = hi[:, 0], hi[:, 1], pa[:, 0], pa[:, 1]
        bel = lambda p: below.gather(1, p[:, None])[:, 0]  # noqa: E731
        # single i -> a: a†_a a_i |n> = s |m>
        s1 = bel(i) + bel(a) - (i < a).long()
        occ = n.double()
        h_s = self.h1[a, i] + (self.W[a, i] * occ).sum(-1)
        h_s = torch.where(s1 % 2 == 1, -h_s, h_s)
        # double (i, j) -> (a, b): a†_a a†_b a_j a_i |n> = s |m>
        s2 = (bel(i) + bel(j) - (i < j).long() + bel(b) - (i < b).long() - (j < b).long()
              + bel(a) - (i < a).long() - (j < a).long() + (b < a).long())
        h_d = self.V[a, b, i, j]
        h_d = torch.where(s2 % 2 == 1, -h_d, h_d)
        out = torch.zeros(n.shape[0], dtype=torch.float64, device=n.device)
        out = torch.where(nh == 0, self.diagonal(n), out)
        out = torch.where((nh == 1) & same_spin, h_s, out)
        out = torch.where((nh == 2) & same_spin, h_d, out)
        return out


def _combos(n: int, k: int, device):
    c = torch.combinations(torch.arange(n, device=device), k)
    return c if c.numel() else torch.zeros(0, k, dtype=torch.long, device=device)


def connected(bits, sorb: int, noa: int, nob: int):
    """Every single and double excitation (alpha and beta counts kept) of
    each row: [B, n_sd, sorb] int8."""
    B, dev = bits.shape[0], bits.device
    b = bits.long()
    outs, occ, vir = [], {}, {}
    for s, ne in ((0, noa), (1, nob)):
        ch = b[:, s::2]
        o = torch.argsort(-ch * ch.shape[1] + torch.arange(ch.shape[1], device=dev), -1)
        occ[s], vir[s] = 2 * o[:, :ne] + s, 2 * o[:, ne:] + s

    def flip(rows, pos):
        r = rows.clone()
        r.scatter_(-1, pos, 1 - r.gather(-1, pos))
        return r

    base = bits.to(torch.int8)
    for s in (0, 1):  # singles
        o, v = occ[s], vir[s]
        i = o[:, :, None].expand(-1, -1, v.shape[1]).reshape(B, -1)
        a = v[:, None, :].expand(-1, o.shape[1], -1).reshape(B, -1)
        outs.append(flip(base[:, None].expand(-1, i.shape[1], -1),
                         torch.stack([i, a], -1)))
    for s in (0, 1):  # same-spin doubles
        o, v = occ[s], vir[s]
        co, cv = _combos(o.shape[1], 2, dev), _combos(v.shape[1], 2, dev)
        oi = o[:, co].reshape(B, -1, 1, 2).expand(-1, -1, cv.shape[0], -1)
        va = v[:, cv].reshape(B, 1, -1, 2).expand(-1, co.shape[0], -1, -1)
        pos = torch.cat([oi, va], -1).reshape(B, -1, 4)
        outs.append(flip(base[:, None].expand(-1, pos.shape[1], -1), pos))
    oa, va, ob, vb = occ[0], vir[0], occ[1], vir[1]
    sa = torch.stack([oa[:, :, None].expand(-1, -1, va.shape[1]),
                      va[:, None, :].expand(-1, oa.shape[1], -1)], -1).reshape(B, -1, 2)
    sb = torch.stack([ob[:, :, None].expand(-1, -1, vb.shape[1]),
                      vb[:, None, :].expand(-1, ob.shape[1], -1)], -1).reshape(B, -1, 2)
    pos = torch.cat([sa[:, :, None].expand(-1, -1, sb.shape[1], -1),
                     sb[:, None].expand(-1, sa.shape[1], -1, -1)], -1).reshape(B, -1, 4)
    outs.append(flip(base[:, None].expand(-1, pos.shape[1], -1), pos))
    return torch.cat(outs, 1)


# ---------------------------------------------------------------- the ansatz

def _exchange(V: np.ndarray, norb: int) -> np.ndarray:
    K = np.zeros((norb, norb))
    idx = np.arange(norb)
    for si in (0, 1):
        for sj in (0, 1):
            p, q = 2 * idx[:, None] + si, 2 * idx[None, :] + sj
            K += np.abs(V[p, q, q, p])
    np.fill_diagonal(K, 0.0)
    return K


def graph_preds(ham: Hamiltonian, max_preds: int) -> list:
    """Predecessors of each site: the previous site, then (max_preds 2)
    the earlier site of largest exchange |K| (ties to the larger index)."""
    norb = ham.sorb // 2
    preds = [[]] + [[t - 1] for t in range(1, norb)]
    if max_preds > 1:
        K = _exchange(ham.V.cpu().numpy(), norb)
        for t in range(2, norb):
            ranked = sorted(((K[u, t], u) for u in range(t - 1)), reverse=True)
            preds[t] += [u for _, u in ranked[: max_preds - 1]]
    return preds


def _q(x, quant):
    if quant is None:
        return x
    s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


def log_psi(P: dict, preds, bits, noa: int, nob: int, *, use_tensor=False, quant=None):
    """(log|psi|, arg psi) [N, 2] of rows bits [N, sorb] in float32 (the
    products in ``quant``'s precision where given)."""
    bits = bits.long()
    B, sorb = bits.shape
    norb = sorb // 2
    d = P["v_re"].shape[-1]
    al, be = bits[:, 0::2], bits[:, 1::2]
    vals = al + 2 * be
    used_a, used_b = torch.cumsum(al, -1) - al, torch.cumsum(be, -1) - be

    def lin(h, W):  # h [B, e], W [4, o, e] -> [B, 4, o]
        return (_q(h, quant) @ _q(W, quant).reshape(-1, W.shape[-1]).T).view(B, 4, -1)

    h = {}
    log_amp = torch.zeros(B, dtype=torch.float32, device=bits.device)
    phase = torch.zeros(B, dtype=torch.float32, device=bits.device)
    for t in range(norb):
        ht_re = P["v_re"][t].expand(B, 4, d)
        ht_im = P["v_im"][t].expand(B, 4, d)
        for j, p in enumerate(preds[t]):
            hr, hi = h[p]
            Mr, Mi = P["M_re"][t, j], P["M_im"][t, j]
            ht_re = ht_re + lin(hr, Mr) - lin(hi, Mi)
            ht_im = ht_im + lin(hi, Mr) + lin(hr, Mi)
        if use_tensor and len(preds[t]) >= 2:
            pr_re = pr_im = None
            for j, p in enumerate(preds[t]):
                hr, hi = h[p]
                Ur, Ui = P["U_re"][t, j], P["U_im"][t, j]
                u_re, u_im = lin(hr, Ur) - lin(hi, Ui), lin(hi, Ur) + lin(hr, Ui)
                if pr_re is None:
                    pr_re, pr_im = u_re, u_im
                else:
                    pr_re, pr_im = pr_re * u_re - pr_im * u_im, pr_re * u_im + pr_im * u_re
            Kr, Ki = _q(P["K_re"][t], quant), _q(P["K_im"][t], quant)  # [4, d, c]
            qr, qi = _q(pr_re, quant).transpose(0, 1), _q(pr_im, quant).transpose(0, 1)
            ht_re = ht_re + (qr @ Kr.transpose(1, 2) - qi @ Ki.transpose(1, 2)).transpose(0, 1)
            ht_im = ht_im + (qi @ Kr.transpose(1, 2) + qr @ Ki.transpose(1, 2)).transpose(0, 1)
        sq = ht_re ** 2 + ht_im ** 2
        w = (torch.nn.functional.softplus(P["eta"][t])[None] * sq).sum(-1)
        logw = torch.log(torch.clamp(w, min=1e-30))
        rem = norb - t - 1
        ua, ub = used_a[:, t], used_b[:, t]
        occ_a, emp_a = ua + 1 <= noa, noa - ua <= rem
        occ_b, emp_b = ub + 1 <= nob, nob - ub <= rem
        mask = torch.stack([emp_a & emp_b, occ_a & emp_b, emp_a & occ_b, occ_a & occ_b], -1)
        logw = torch.where(mask, logw, torch.full_like(logw, -1e30))
        logp = logw - torch.logsumexp(logw, -1, keepdim=True)
        x = vals[:, t]
        log_amp = log_amp + 0.5 * logp.gather(1, x[:, None])[:, 0]
        nrm = torch.rsqrt(torch.clamp(sq.mean((-2, -1)), min=1e-30))[:, None]
        idx = x[:, None, None].expand(-1, 1, d)
        hr = ht_re.gather(1, idx)[:, 0] * nrm
        hi = ht_im.gather(1, idx)[:, 0] * nrm
        h[t] = (hr, hi)
        wr, wi = P["w_arg_re"][t], P["w_arg_im"][t]
        z_re = hr @ wr - hi @ wi + P["c_arg_re"][t]
        z_im = hi @ wr + hr @ wi + P["c_arg_im"][t]
        phase = phase + torch.atan2(z_im, z_re)
    return torch.stack([log_amp, phase + P["global_phase"]], -1)


def log_psi_blocks(P, preds, bits, noa, nob, *, use_tensor=False, quant=None, block=65536):
    with torch.no_grad():
        return torch.cat([log_psi(P, preds, bits[s:s + block], noa, nob,
                                  use_tensor=use_tensor, quant=quant)
                          for s in range(0, bits.shape[0], block)], 0)


def _ratio(lp_m, lp_n):
    """Re and Im of psi(m)/psi(n) in float64."""
    r = torch.exp(lp_m[..., 0].double() - lp_n[..., 0].double())
    dphi = lp_m[..., 1].double() - lp_n[..., 1].double()
    return r * torch.cos(dphi), r * torch.sin(dphi)


# ---------------------------------------------------------------- local energies

def _keys(rows):
    """One int64 per row of bits [..., sorb <= 63]."""
    w = 2 ** torch.arange(rows.shape[-1], device=rows.device, dtype=torch.long)
    return (rows.long() * w).sum(-1)


def selection_faults(h_conn, n, det, tail, h_det, h_st, tie_rel: float = 1e-5):
    """Per sample, the rows that break REDUCE's split: deterministic rows
    that are not among the k_det largest |H| of all excitations (|H| below
    the k-th largest by more than ``tie_rel`` of the largest, for ties and
    the program's float32 elements), repeated deterministic rows, and tail
    rows that are a deterministic row, the sample itself or no excitation
    (H = 0).  h_conn [b, n_sd] are the |H| of every excitation."""
    k = det.shape[1]
    kth = torch.topk(h_conn, k, dim=1).values[:, -1]
    tol = tie_rel * h_conn.amax(1)
    bad = (h_det.abs() < (kth - tol)[:, None]).sum(-1)
    kd, kt, kn = _keys(det), _keys(tail), _keys(n)[:, None]
    srt = torch.sort(kd, 1).values
    bad += (srt[:, 1:] == srt[:, :-1]).sum(-1) + (kd == kn).sum(-1)
    bad += (kt[:, :, None] == kd[:, None, :]).any(-1).sum(-1)
    bad += ((kt == kn) | (h_st == 0)).sum(-1)
    return bad


def reduce_eloc(ham: Hamiltonian, fwd, rows, k_det: int, n_stoch: int, block: int = 64):
    """REDUCE local energies [S, 2] of S samples from the rows the program
    evaluated for them, rows [S, 1 + k_det + n_stoch, sorb] (the sample,
    its deterministic children, its tail draws): the deterministic terms
    exactly, the tail as (S_tail / n_stoch) sum sign(H) ratio, with H and
    S_tail = sum over all excitations of |H| minus the deterministic |H|
    from this module's Hamiltonian, and psi from ``fwd``.  Also returns
    each sample's scale [S], the sum of the magnitudes of its terms, and
    its count of ``selection_faults`` [S]."""
    S, R, sorb = rows.shape
    out, scales, faults = [], [], []
    for s in range(0, S, block):
        r = rows[s:s + block]
        b = r.shape[0]
        n = r[:, 0]
        h_all = ham.between(n.repeat_interleave(R - 1, 0), r[:, 1:].reshape(-1, sorb))
        h_all = h_all.view(b, R - 1)
        conn = connected(n, sorb, ham.noa, ham.nob)
        h_conn = ham.between(n.repeat_interleave(conn.shape[1], 0),
                             conn.reshape(-1, sorb)).view(b, -1).abs()
        s_tot = h_conn.sum(-1)
        h_det, h_st = h_all[:, :k_det], h_all[:, k_det:]
        faults.append(selection_faults(h_conn, n, r[:, 1:1 + k_det], r[:, 1 + k_det:],
                                       h_det, h_st))
        s_tail = s_tot - h_det.abs().sum(-1)
        lp = fwd(r.reshape(-1, sorb)).view(b, R, 2)
        re, im = _ratio(lp[:, 1:], lp[:, :1])
        sg = torch.sign(h_st)
        scale = s_tail / n_stoch
        e_re = (ham.diagonal(n) + (h_det * re[:, :k_det]).sum(-1)
                + scale * (sg * re[:, k_det:]).sum(-1))
        e_im = (h_det * im[:, :k_det]).sum(-1) + scale * (sg * im[:, k_det:]).sum(-1)
        out.append(torch.stack([e_re, e_im], -1))
        mag = torch.hypot(re, im)
        scales.append(ham.diagonal(n).abs() + (h_det.abs() * mag[:, :k_det]).sum(-1)
                      + scale * mag[:, k_det:].sum(-1))
    return torch.cat(out, 0), torch.cat(scales, 0), torch.cat(faults, 0)


def green_row_from(ham: Hamiltonian, walkers, comb, lp, *, quant=None, block: int = 64):
    """(e_loc [W], b [W], scale [W], Lambda) of fixed-node GFMC at gamma 0
    from the rows comb [W, M, sorb] (row 0 the walker, then its
    excitations) and their trial values lp [W * M, 2], with the matrix
    elements of this module's Hamiltonian: t_m = H_nm Re[psi(m)/psi(n)],
    e_fn = H_nn + sum_{t>0} t, Lambda = max e_fn + 1, e_loc = H_nn +
    sum t, b = Lambda - e_fn + sum_{t<0} (-t), scale = |H_nn| + sum |t|.
    ``quant="bf16"`` rounds the matrix elements and the ratios to
    bfloat16 (the control)."""
    W, M, sorb = comb.shape
    lp = lp.view(W, M, 2)
    e_loc, e_fn, neg, scale = [], [], [], []
    for s in range(0, W, block):
        n, c = walkers[s:s + block], comb[s:s + block]
        b = n.shape[0]
        h = ham.between(n.repeat_interleave(M - 1, 0), c[:, 1:].reshape(-1, sorb)).view(b, M - 1)
        r = _ratio(lp[s:s + block, 1:], lp[s:s + block, :1])[0]
        if quant == "bf16":
            h, r = h.to(torch.bfloat16).double(), r.to(torch.bfloat16).double()
        t = h * r
        hd = ham.diagonal(n)
        e_loc.append(hd + t.sum(-1))
        e_fn.append(hd + torch.where(t > 0, t, 0.0).sum(-1))
        neg.append(torch.where(t < 0, -t, 0.0).sum(-1))
        scale.append(hd.abs() + t.abs().sum(-1))
    e_loc, e_fn, neg = torch.cat(e_loc), torch.cat(e_fn), torch.cat(neg)
    lam = e_fn.max() + 1.0
    return e_loc, lam - e_fn + neg, torch.cat(scale), lam


def is_move(prev, nxt, sorb: int):
    """[W] bool: nxt equals prev or is one of its single or double
    excitations with the alpha and beta counts kept."""
    p, q = prev.long(), nxt.long()
    holes, parts = p * (1 - q), q * (1 - p)
    nh = holes.sum(-1)
    return ((nh <= 2) & (holes[:, 0::2].sum(-1) == parts[:, 0::2].sum(-1))
            & (holes[:, 1::2].sum(-1) == parts[:, 1::2].sum(-1)))


# ---------------------------------------------------------------- training

def energy_grad(P: dict, preds, bits, w, eloc, noa, nob, *, use_tensor=False, block=8192,
                tf32=False):
    """The pair-form gradient 2 sum_n w_n [(a_n - a) du_n + (b_n - b) dv_n]
    of E_loc = a + ib, log psi = u + iv, over rows with w > 0, by autograd
    through ``log_psi``; ``tf32`` runs its products in TF32."""
    alive = w > 0
    bits, w, eloc = bits[alive], w[alive].double(), eloc[alive].double()
    cen = (eloc - (w[:, None] * eloc).sum(0)).float()
    params = {k: v.detach().clone().requires_grad_(True) for k, v in P.items()}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for s in range(0, bits.shape[0], block):
            lp = log_psi(params, preds, bits[s:s + block], noa, nob, use_tensor=use_tensor)
            loss = 2.0 * (w[s:s + block].float() * (cen[s:s + block] * lp).sum(-1)).sum()
            for k, g in zip(params, torch.autograd.grad(loss, list(params.values()),
                                                        allow_unused=True)):
                if g is not None:
                    grads[k] += g
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return grads


def clip_scale(grads: dict, clip: float) -> float:
    gnorm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
    return min(1.0, clip / max(gnorm, 1e-30))


def adamw_steps(P0: dict, grads_seq, lrs, *, b1=0.9, b2=0.999, eps=1e-8, wd=1e-4) -> dict:
    """Parameters after AdamW updates with the gradients ``grads_seq``
    (already clipped) at the learning rates ``lrs``: decoupled decay
    p <- p (1 - lr wd), then p <- p - lr m_hat / (sqrt(v_hat) + eps)."""
    p = {k: v.detach().clone() for k, v in P0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    for t, (g, lr) in enumerate(zip(grads_seq, lrs), 1):
        for k in p:
            m[k] = b1 * m[k] + (1 - b1) * g[k]
            v2[k] = b2 * v2[k] + (1 - b2) * g[k] ** 2
            mh, vh = m[k] / (1 - b1 ** t), v2[k] / (1 - b2 ** t)
            p[k] = p[k] * (1 - lr * wd) - lr * mh / (vh.sqrt() + eps)
    return p
