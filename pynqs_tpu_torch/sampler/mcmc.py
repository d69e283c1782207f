"""Metropolis MCMC sampler with spin-conserving exchange moves.

Counterpart of ``pynqs_tpu/sampler/mcmc.py``: many parallel chains, each
proposal exchanging one occupied and one virtual spin orbital of the
same spin channel (so (noa, nob) is kept), with probability ``p_double``
a second exchange composed on top; acceptance |ψ'/ψ|² (the proposal is
symmetric).  The chain batch is one ``model.log_psi`` per step.  Draws
take an explicit ``torch.Generator``; the streams differ from
``jax.random``.

A stateful sampler: ``init_state`` gives the chains, ``sample`` returns
them updated (``VMC`` threads them through its steps and thermalizes
them once with ``therm`` extra steps before its loop).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pynqs_tpu_torch.ops import onv
from pynqs_tpu_torch.utils.device import model_device_dtype

__all__ = ["MCMCSampler", "exchange_proposal"]


def exchange_proposal(bits, u, noa: int, nob: int):
    """One spin-conserving occupied ↔ virtual exchange per chain from the
    uniforms u [nc, 3]: the channel (β where u₀ ≥ ½, when both channels
    can move), the ⌊u₁·n_occ⌋-th occupied and the ⌊u₂·n_vir⌋-th virtual
    orbital of that channel, each counted upward (``merged_orbital_list``'s
    slots)."""
    norb = bits.shape[-1] // 2
    nva, nvb = norb - noa, norb - nob
    can_a, can_b = noa > 0 and nva > 0, nob > 0 and nvb > 0
    if can_a and can_b:
        ch = (u[:, 0] >= 0.5).long()
    else:
        ch = torch.full_like(u[:, 0], 0 if can_a else 1, dtype=torch.long)
    no_c = torch.where(ch == 0, noa, nob)
    nv_c = torch.where(ch == 0, nva, nvb)
    io = (u[:, 1] * no_c).long()
    iv = (u[:, 2] * nv_c).long()
    merged = onv.merged_orbital_list(bits, noa, nob)
    p_occ = merged.gather(1, (2 * io + ch)[:, None])
    p_vir = merged.gather(1, (2 * (no_c + iv) + ch)[:, None])
    flip = torch.zeros_like(bits)
    flip.scatter_(1, p_occ, 1)
    flip.scatter_(1, p_vir, 1)
    return bits ^ flip


@dataclass(frozen=True)
class MCMCSampler:
    sorb: int
    noa: int
    nob: int
    n_chain: int = 1024
    n_sweep: int = 32  # Metropolis steps between returned sample sets
    therm: int = 256  # extra steps once, before the VMC loop
    # probability of composing a second exchange into the proposal
    # (double excitations; both moves are symmetric)
    p_double: float = 0.25

    stateful = True

    def init_state(self, model, generator: torch.Generator) -> torch.Tensor:
        """Chains [n_chain, sorb] int8 at uniformly random (noa, nob)
        determinants, on the model's device."""
        dev = model_device_dtype(model)[0]
        norb = self.sorb // 2

        def channel(n):
            keys = torch.rand(self.n_chain, norb, generator=generator, device=dev)
            occ = torch.zeros(self.n_chain, norb, dtype=torch.int8, device=dev)
            return occ.scatter_(1, keys.argsort(-1)[:, :n], 1)

        return torch.stack([channel(self.noa), channel(self.nob)], -1).reshape(
            self.n_chain, self.sorb)

    def _propose(self, bits, generator):
        u = torch.rand(bits.shape[0], 3, generator=generator, device=bits.device,
                       dtype=torch.float64)
        return exchange_proposal(bits, u, self.noa, self.nob)

    @torch.no_grad()
    def run(self, model, generator: torch.Generator, bits, n_steps: int):
        """``n_steps`` Metropolis updates of the chains ``bits``; returns
        (bits, log_psi [n_chain, 2], acceptance rate as a 0-d tensor)."""
        lp = model.log_psi(bits)
        nc = bits.shape[0]
        acc_sum = torch.zeros((), dtype=lp.dtype, device=lp.device)
        for _ in range(n_steps):
            nb = self._propose(bits, generator)
            if self.p_double > 0:
                nb2 = self._propose(nb, generator)
                dbl = torch.rand(nc, generator=generator, device=bits.device) < self.p_double
                nb = torch.where(dbl[:, None], nb2, nb)
            nlp = model.log_psi(nb)
            u = torch.rand(nc, generator=generator, device=bits.device, dtype=lp.dtype)
            acc = torch.log(u) < 2 * (nlp[:, 0] - lp[:, 0])
            bits = torch.where(acc[:, None], nb, bits)
            lp = torch.where(acc[:, None], nlp, lp)
            acc_sum = acc_sum + acc.to(lp.dtype).mean()
        return bits, lp, acc_sum / max(n_steps, 1)

    def sample(self, model, generator: torch.Generator, state):
        """(bits, weights 1/n_chain, diagnostics, new state) after
        ``n_sweep`` steps from the chains ``state``; ``dropped_frac`` is
        −1 (not measured), ``acc_rate`` the acceptance rate."""
        bits, lp, acc = self.run(model, generator, state, self.n_sweep)
        w = torch.full((self.n_chain,), 1.0 / self.n_chain, dtype=lp.dtype, device=lp.device)
        diag = {"dropped_frac": torch.tensor(-1.0, dtype=lp.dtype, device=lp.device),
                "n_unique": (w > 0).sum(), "acc_rate": acc}
        return bits, w, diag, bits
