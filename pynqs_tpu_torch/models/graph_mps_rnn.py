"""Graph-MPS-RNN: tensor-network RNN over an orbital DAG.

Counterpart of ``pynqs_tpu/models/graph_mps_rnn.py``.  Spatial orbitals
are visited in a topological order of a DAG; site i has values
x ∈ {0: empty, 1: ↑, 2: ↓, 3: ↑↓} and a complex hidden h_i ∈ C^dcut:

    h̃_i(x) = Σ_{p ∈ pred(i)} M_{i,p,x} · h_p  +  v_{i,x}
             (+ K_{i,x} · Π_p U_{i,p,x} h_p  at multi-predecessor sites
              when use_tensor)
    P(x_i = x | prefix) ∝ Σ_d softplus(η_{i,x,d}) |h̃_i(x)_d|²,
                          masked by (N, Sz) feasibility
    h_i = h̃_i(x_i) · gauge        ("unit": 1/‖h̃_i(x_i)‖,
                                   "mpsrnn": 1/sqrt(mean_{x,d}|h̃_i|²))
    φ_i = arg(w_i · h_i + c_i)    ("arg") or w_{i,x}·[Re h; Im h] + c_{i,x}
                                  ("linear")
    log ψ = Σ_i [½ log P(x_i) + i φ_i] + i·global_phase + i·π·[sgn_perm < 0]

Complex numbers are carried as (re, im) pairs, and the parameters keep
the JAX package's key names so its parameter trees load unchanged.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pynqs_tpu_torch.ops import onv as onv_ops
from pynqs_tpu_torch.ops.cplx import safe_atan2
from pynqs_tpu_torch.sampler.symmetry import apply_mask_logp, mask_two_site
from pynqs_tpu_torch.utils.device import resolve_device

__all__ = ["GraphMPSRNN", "chain_graph", "grid_snake_graph", "graph_from_edges"]


def graph_from_edges(norb: int, edges, order=None):
    """(order, preds) from DAG edges (u -> v means h_u feeds v); preds
    are listed in visiting order."""
    if order is None:
        order = list(range(norb))
    pos = {s: t for t, s in enumerate(order)}
    preds = [[] for _ in range(norb)]
    for u, v in edges:
        if pos[u] >= pos[v]:
            raise ValueError(f"edge {u}->{v} not forward in visiting order")
        preds[pos[v]].append(u)
    return order, preds


def chain_graph(norb: int, order=None):
    """1D MPS-RNN: each site's predecessor is the previous in order."""
    if order is None:
        order = list(range(norb))
    edges = [(order[t - 1], order[t]) for t in range(1, norb)]
    return graph_from_edges(norb, edges, order)


def grid_snake_graph(nx: int, ny: int):
    """2D snake-ordered lattice: chain neighbour + vertical neighbour."""
    norb = nx * ny

    def site(r, c):
        return r * nx + (c if r % 2 == 0 else nx - 1 - c)

    order = [site(r, c) for r in range(ny) for c in range(nx)]
    edges = [(order[t - 1], order[t]) for t in range(1, norb)]
    for r in range(1, ny):
        for c in range(nx):
            s = r * nx + c
            p = (r - 1) * nx + c
            if (p, s) not in edges and (s, p) not in edges:
                edges.append((p, s))
    return graph_from_edges(norb, edges, order)


def _cmul(a_re, a_im, b_re, b_im):
    return a_re * b_re - a_im * b_im, a_re * b_im + a_im * b_re


class GraphMPSRNN(nn.Module):
    sites_per_step = 2

    def __init__(
        self,
        sorb: int,
        noa: int,
        nob: int,
        dcut: int = 16,
        graph=None,
        *,
        phase_mode: str = "linear",
        norm_mode: str = "unit",
        use_tensor: bool = False,
        dcut_cmpr: int = 4,
        dtype=torch.float64,
        device="cuda",
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if phase_mode not in ("arg", "linear"):
            raise ValueError(f"unknown phase_mode {phase_mode!r}")
        if norm_mode not in ("mpsrnn", "unit"):
            raise ValueError(f"unknown norm_mode {norm_mode!r}")
        self.sorb, self.noa, self.nob, self.dcut = sorb, noa, nob, dcut
        self.phase_mode, self.norm_mode = phase_mode, norm_mode
        self.use_tensor, self.dcut_cmpr = use_tensor, dcut_cmpr
        norb = sorb // 2
        order, preds = graph if graph is not None else chain_graph(norb)
        self.site_order = tuple(int(s) for s in order)
        self.preds = tuple(tuple(int(p) for p in ps) for ps in preds)
        self.maxp = max(1, max(len(p) for p in preds))
        self._pred = np.zeros((norb, self.maxp), np.int64)
        self._pred_mask = np.zeros((norb, self.maxp), np.float64)
        for t, ps in enumerate(preds):
            self._pred[t, : len(ps)] = ps
            self._pred_mask[t, : len(ps)] = 1.0
        so = np.asarray(order)
        self._so_order = np.stack([2 * so, 2 * so + 1], 1).reshape(-1)
        self._sgnA = onv_ops.permute_sgn_matrix(self._so_order)
        self.is_chain = self.maxp == 1 and all(
            self.preds[t] == (self.site_order[t - 1],) for t in range(1, norb)
        )
        self._init_params(resolve_device(device), dtype, generator)

    @property
    def norb(self) -> int:
        return self.sorb // 2

    def _init_params(self, dev, dtype, gen):
        for k, v in self._draw_params(dev, dtype, gen).items():
            self.register_parameter(k, nn.Parameter(v.contiguous()))

    def init_params(self, generator: torch.Generator | None = None) -> dict:
        """A fresh draw of the initial parameters (the rule of ``__init__``)
        as numpy arrays in the model's dtype: the counterpart of the JAX
        model's ``init(key)`` for the warm starts (``utils/mps_import.py``)."""
        p = self._draw_params(torch.device("cpu"), self.M_re.dtype, generator)
        return {k: v.numpy() for k, v in p.items()}

    def _draw_params(self, dev, dtype, gen) -> dict:
        norb, d, mp = self.norb, self.dcut, self.maxp
        s = 1.0 / np.sqrt(d * mp)
        shapeM = (norb, mp, 4, d, d)

        def nrm(shape, scale):
            return scale * torch.randn(
                shape, generator=gen, dtype=dtype, device="cpu"
            ).to(dev)

        eye = torch.eye(d, dtype=dtype, device=dev).expand(shapeM)
        p = {
            "M_re": eye / mp + nrm(shapeM, 0.1 * s),
            "M_im": nrm(shapeM, 0.1 * s),
            "v_re": nrm((norb, 4, d), 0.1),
            "v_im": nrm((norb, 4, d), 0.1),
            "eta": torch.ones((norb, 4, d), dtype=dtype, device=dev),
            "global_phase": torch.zeros((), dtype=dtype, device=dev),
        }
        if self.use_tensor:
            dc = self.dcut_cmpr
            p["U_re"] = nrm((norb, mp, 4, dc, d), 0.1 / np.sqrt(d))
            p["U_im"] = nrm((norb, mp, 4, dc, d), 0.1 / np.sqrt(d))
            p["K_re"] = nrm((norb, 4, d, dc), 0.1 / np.sqrt(dc))
            p["K_im"] = nrm((norb, 4, d, dc), 0.1 / np.sqrt(dc))
        if self.phase_mode == "linear":
            p["w_ph"] = nrm((norb, 4, 2 * d), 1.0 / np.sqrt(2 * d))
            p["c_ph"] = torch.zeros((norb, 4), dtype=dtype, device=dev)
        else:
            p["w_arg_re"] = nrm((norb, d), 1.0 / np.sqrt(d))
            p["w_arg_im"] = nrm((norb, d), 1.0 / np.sqrt(d))
            p["c_arg_re"] = torch.ones((norb,), dtype=dtype, device=dev)
            p["c_arg_im"] = torch.zeros((norb,), dtype=dtype, device=dev)
        return p

    def load_numpy_params(self, tree: dict):
        """Copy a JAX parameter tree (numpy leaves, same key names) in."""
        params = dict(self.named_parameters())
        if set(tree) != set(params):
            raise KeyError(
                f"parameter keys differ: {sorted(set(tree) ^ set(params))}"
            )
        with torch.no_grad():
            for k, v in tree.items():
                p = params[k]
                p.copy_(torch.as_tensor(np.array(v)).reshape(p.shape).to(p.dtype))
        return self

    # ---------------- core site update ----------------

    def _site_update(self, t: int, hp_re, hp_im, h_of):
        """Candidate hiddens of site t for all 4 values.

        hp_{re,im}: [B, n_pred, d] predecessor hiddens (n_pred may be 0);
        h_of(j) -> (re, im) of predecessor j, for the tensor coupling.
        Returns (ht_re, ht_im [B, 4, d], logw [B, 4])."""
        n = hp_re.shape[1]
        ht_re = self.v_re[t].expand(hp_re.shape[0], 4, self.dcut)
        ht_im = self.v_im[t].expand(hp_re.shape[0], 4, self.dcut)
        if n:
            M_re, M_im = self.M_re[t, :n], self.M_im[t, :n]
            ht_re = ht_re + torch.einsum("pxde,bpe->bxd", M_re, hp_re) - torch.einsum(
                "pxde,bpe->bxd", M_im, hp_im
            )
            ht_im = ht_im + torch.einsum("pxde,bpe->bxd", M_re, hp_im) + torch.einsum(
                "pxde,bpe->bxd", M_im, hp_re
            )
        if self.use_tensor and n >= 2:
            pr_re = pr_im = None
            for j in range(n):
                hj_re, hj_im = h_of(j)
                Ur, Ui = self.U_re[t, j], self.U_im[t, j]  # [4, dc, d]
                u_re = torch.einsum("xcd,bd->bxc", Ur, hj_re) - torch.einsum(
                    "xcd,bd->bxc", Ui, hj_im
                )
                u_im = torch.einsum("xcd,bd->bxc", Ur, hj_im) + torch.einsum(
                    "xcd,bd->bxc", Ui, hj_re
                )
                if pr_re is None:
                    pr_re, pr_im = u_re, u_im
                else:
                    pr_re, pr_im = _cmul(pr_re, pr_im, u_re, u_im)
            Kr, Ki = self.K_re[t], self.K_im[t]  # [4, d, dc]
            ht_re = ht_re + torch.einsum("xdc,bxc->bxd", Kr, pr_re) - torch.einsum(
                "xdc,bxc->bxd", Ki, pr_im
            )
            ht_im = ht_im + torch.einsum("xdc,bxc->bxd", Kr, pr_im) + torch.einsum(
                "xdc,bxc->bxd", Ki, pr_re
            )
        eta = F.softplus(self.eta[t])[None]
        w = (eta * (ht_re**2 + ht_im**2)).sum(-1)
        return ht_re, ht_im, torch.log(torch.clamp(w, min=1e-30))

    def _select_h(self, ht_re, ht_im, x):
        """Value x's hidden with the normalization gauge applied."""
        idx = x.long()[:, None, None].expand(-1, 1, self.dcut)
        sel_re = torch.gather(ht_re, 1, idx)[:, 0]
        sel_im = torch.gather(ht_im, 1, idx)[:, 0]
        if self.norm_mode == "mpsrnn":
            m = (ht_re**2 + ht_im**2).mean((-2, -1))
            nrm = torch.rsqrt(torch.clamp(m, min=1e-30))[:, None]
        else:
            m = (sel_re**2 + sel_im**2).sum(-1, keepdim=True)
            nrm = torch.rsqrt(torch.clamp(m, min=1e-30))
        return sel_re * nrm, sel_im * nrm

    def _phase_site(self, t: int, x, h_re, h_im):
        if self.phase_mode == "arg":
            wr, wi = self.w_arg_re[t], self.w_arg_im[t]
            z_re = h_re @ wr - h_im @ wi + self.c_arg_re[t]
            z_im = h_im @ wr + h_re @ wi + self.c_arg_im[t]
            return safe_atan2(z_im, z_re)
        hcat = torch.cat([h_re, h_im], -1)
        x = x.long()
        return (self.w_ph[t][x] * hcat).sum(-1) + self.c_ph[t][x]

    # ---------------- forward ----------------

    def sign_phase(self, bits: torch.Tensor, dtype) -> torch.Tensor:
        """π·[reordering sign < 0] per row, in ``dtype``."""
        sgn = onv_ops.permute_sgn(bits[:, self._so_order], self._sgnA)
        return (1 - sgn).to(dtype) * (np.pi / 2)

    def log_psi(self, bits: torch.Tensor) -> torch.Tensor:
        """bits [N, sorb] (or [sorb]) -> [N, 2] = (log|ψ|, arg ψ)."""
        squeeze = bits.dim() == 1
        if squeeze:
            bits = bits[None]
        bits = bits.long()
        B = bits.shape[0]
        norb, d = self.norb, self.dcut
        order = list(self.site_order)
        vals = bits[:, 0::2] + 2 * bits[:, 1::2]  # [B, norb] by site id
        cum_a = torch.cumsum(bits[:, 0::2][:, order], -1)
        cum_b = torch.cumsum(bits[:, 1::2][:, order], -1)
        used_a = cum_a - bits[:, 0::2][:, order]
        used_b = cum_b - bits[:, 1::2][:, order]

        dt = self.M_re.dtype
        no_pred = torch.zeros(B, 0, d, dtype=dt, device=bits.device)
        h: dict[int, tuple] = {}
        log_amp = torch.zeros(B, dtype=dt, device=bits.device)
        phase = torch.zeros(B, dtype=dt, device=bits.device)
        for t in range(norb):
            s = order[t]
            x = vals[:, s]
            ps = self.preds[t]
            hs = [h[p] for p in ps]
            hp_re = torch.stack([a for a, _ in hs], 1) if hs else no_pred
            hp_im = torch.stack([b for _, b in hs], 1) if hs else no_pred
            ht_re, ht_im, logw = self._site_update(t, hp_re, hp_im, lambda j: hs[j])
            rem = norb - t - 1
            mask = mask_two_site(used_a[:, t], used_b[:, t], self.noa, self.nob, rem, rem)
            logp = apply_mask_logp(logw, mask)
            log_amp = log_amp + 0.5 * torch.gather(logp, 1, x[:, None])[:, 0]
            h[s] = self._select_h(ht_re, ht_im, x)
            phase = phase + self._phase_site(t, x, *h[s])
        phase = phase + self.global_phase + self.sign_phase(bits, dt)
        out = torch.stack([log_amp, phase], -1)
        return out[0] if squeeze else out

    forward = log_psi

    # ---------------- AR-sampling contract ----------------

    def ar_init(self, capacity: int):
        dev, dt = self.M_re.device, self.M_re.dtype
        z = torch.zeros(capacity, self.norb, self.dcut, dtype=dt, device=dev)
        zc = torch.zeros(capacity, 4, self.dcut, dtype=dt, device=dev)
        return {"h_re": z, "h_im": z.clone(), "cand_re": zc, "cand_im": zc.clone()}

    def ar_step(self, carry: dict, k: int, prev: torch.Tensor):
        """One AR step at site index k: finalize site k-1's hidden from the
        cached candidates (value ``prev``), then the normalized
        conditional log-probs [C, 4] of site k.  Run under no_grad: the
        register file is updated in place."""
        h_re, h_im = carry["h_re"], carry["h_im"]
        if k > 0:
            s_prev = self.site_order[k - 1]
            sel_re, sel_im = self._select_h(carry["cand_re"], carry["cand_im"], prev)
            h_re[:, s_prev] = sel_re
            h_im[:, s_prev] = sel_im
        ps = list(self.preds[k])
        ht_re, ht_im, logw = self._site_update(
            k, h_re[:, ps], h_im[:, ps], lambda j: (h_re[:, ps[j]], h_im[:, ps[j]])
        )
        logp = logw - torch.logsumexp(logw, -1, keepdim=True)
        return logp, {"h_re": h_re, "h_im": h_im, "cand_re": ht_re, "cand_im": ht_im}
