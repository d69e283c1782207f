"""Electronic-structure system container.

Counterpart of ``pynqs_tpu/utils/system.py``: electron counts, the
compressed integrals and the core energy, with the Slater–Condon
operand tables moved to a device on request; ``from_pth`` reads the
reference's molecule files, ``from_fcidump`` an FCIDUMP.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from pynqs_tpu_torch.ops import integrals as ints
from pynqs_tpu_torch.ops.excitation import ExcitationTable, excitation_table
from pynqs_tpu_torch.utils.device import resolve_device
from pynqs_tpu_torch.utils.torch_io import safe_torch_load

__all__ = ["System", "DeviceTables"]


@dataclass(frozen=True)
class DeviceTables:
    """Slater–Condon operands on one device (see ops/integrals.py)."""

    h1e: torch.Tensor
    h2e: torch.Tensor
    diag1: torch.Tensor
    K: torch.Tensor
    J: torch.Tensor
    # the dense pair matrix [npair, npair] (2.4 MB f32 at sorb 40): the
    # doubles operand of the final-state evaluation; None when the pair
    # space is too large (> 4096 pairs)
    hpair: torch.Tensor | None = None
    # its spin-sector blocks (H_aa, H_bb, H_ab): the training step's
    # doubles operand
    hpair_sect: tuple | None = None

    def astuple(self):
        return (self.h1e, self.h2e, self.diag1, self.K, self.J)

    @property
    def hpair_best(self):
        """comb_hij's doubles operand for the training step: the sector
        blocks where there are any, else the dense matrix."""
        return self.hpair_sect if self.hpair_sect is not None else self.hpair


@dataclass(frozen=True)
class System:
    sorb: int
    noa: int
    nob: int
    h1e: np.ndarray  # [sorb, sorb] dense
    h2e: np.ndarray  # compressed triangle
    ecore: float = 0.0
    e_ref: float | None = None
    ci_space: np.ndarray | None = field(default=None, repr=False)
    dtype: np.dtype = np.float64
    _dev_cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def nele(self) -> int:
        return self.noa + self.nob

    @property
    def norb(self) -> int:
        return self.sorb // 2

    @cached_property
    def excitation(self) -> ExcitationTable:
        return excitation_table(self.sorb, self.noa, self.nob)

    @cached_property
    def host_tables(self) -> ints.HijTables:
        return ints.precompute_hij_tables(self.h1e, self.h2e, self.sorb, self.dtype)

    def tables(self, device="cuda", dtype=None) -> DeviceTables:
        """The operand tables on ``device`` in ``dtype`` (default: the
        system's dtype), built once per (device, dtype)."""
        dev = resolve_device(device)
        dt = torch.from_numpy(np.zeros(0, self.dtype)).dtype if dtype is None else dtype
        key = (str(dev), dt)
        if key not in self._dev_cache:
            t = self.host_tables

            def put(a):
                return torch.as_tensor(np.asarray(a), device=dev).to(dt)

            self._dev_cache[key] = DeviceTables(
                h1e=put(t.h1e),
                h2e=put(t.h2e),
                diag1=put(t.diag1),
                K=put(t.K),
                J=put(t.J),
                hpair=None if t.Hpair is None else put(t.Hpair),
                hpair_sect=None
                if t.Hpair_sect is None
                else tuple(put(b) for b in t.Hpair_sect),
            )
        return self._dev_cache[key]

    def with_operator(self, h1e_p, h2e_p, coeff: float = 1.0) -> "System":
        """The system whose Hamiltonian is H + coeff·O, with O given as
        (dense h1e, compressed h2e), e.g. ``ops.integrals.spin_raising``:
        the Slater–Condon tables are linear in the integrals.  ``e_ref``
        is kept; the new system builds its own device tables."""
        h1e_p = np.asarray(h1e_p, dtype=np.float64)
        if h1e_p.ndim == 1:
            h1e_p = h1e_p.reshape(self.sorb, self.sorb)
        return dataclasses.replace(
            self,
            h1e=self.h1e + coeff * h1e_p,
            h2e=self.h2e + coeff * np.asarray(h2e_p, dtype=np.float64),
            _dev_cache={},
        )

    # ---------------- constructors ----------------

    @classmethod
    def from_integrals(
        cls, h1e, h2e_compressed, sorb: int, noa: int, nob: int,
        ecore: float = 0.0, **kw,
    ) -> "System":
        h1e = np.asarray(h1e, dtype=np.float64)
        if h1e.ndim == 1:
            h1e = h1e.reshape(sorb, sorb)
        return cls(
            sorb=sorb, noa=noa, nob=nob, h1e=h1e,
            h2e=np.asarray(h2e_compressed, dtype=np.float64),
            ecore=float(ecore), **kw,
        )

    @classmethod
    def from_spatial(
        cls, hcore, eri_chemist, noa: int, nob: int, ecore: float = 0.0, **kw
    ) -> "System":
        """Spatial-orbital (hcore, chemist ERI) -> interleaved spin System."""
        h1e, h2e_c = ints.spin_orbital_from_spatial(hcore, eri_chemist)
        return cls.from_integrals(h1e, h2e_c, 2 * hcore.shape[0], noa, nob, ecore, **kw)

    @classmethod
    def from_pth(cls, path: str, **kw) -> "System":
        """A reference-format molecule .pth file (reference
        utils/pyscf_helper/integral.py:20-114): keys h1e [sorb²], h2e
        [triangle], sorb, noa, nob, ecore, optional ci_space (packed uint8
        ONVs) and e_lst (its first entry becomes ``e_ref``)."""
        d = safe_torch_load(path)
        e_lst = d.get("e_lst")
        e_ref = None
        if e_lst is not None and np.asarray(e_lst).size:
            e_ref = float(np.asarray(e_lst).ravel()[0])
        ci_space = d.get("ci_space")
        if ci_space is not None:
            ci_space = np.asarray(ci_space)
        return cls.from_integrals(
            np.asarray(d["h1e"], dtype=np.float64),
            np.asarray(d["h2e"], dtype=np.float64),
            int(d["sorb"]), int(d["noa"]), int(d["nob"]),
            float(d.get("ecore", 0.0)), e_ref=e_ref, ci_space=ci_space, **kw,
        )

    @classmethod
    def from_fcidump(cls, path: str, **kw) -> "System":
        """A restricted FCIDUMP: chemist (ij|kl) with 8-fold symmetry; index-0
        entries are hcore (i, j, 0, 0) and ecore (0, 0, 0, 0)."""
        import re

        with open(path) as f:
            text = f.read()
        header, _, body = text.partition("&END")
        if not body:
            header, _, body = text.partition("/")
        norb = int(re.search(r"NORB\s*=\s*(\d+)", header, re.I).group(1))
        nelec = int(re.search(r"NELEC\s*=\s*(\d+)", header, re.I).group(1))
        m = re.search(r"MS2\s*=\s*(-?\d+)", header, re.I)
        ms2 = int(m.group(1)) if m else 0
        noa = (nelec + ms2) // 2
        nob = nelec - noa
        hcore = np.zeros((norb, norb))
        eri = np.zeros((norb,) * 4)
        ecore = 0.0
        for line in body.strip().splitlines():
            parts = line.split()
            if len(parts) != 5:
                continue
            v = float(parts[0])
            i, j, k, l = (int(x) for x in parts[1:])
            if i == 0:
                ecore = v
            elif k == 0:
                hcore[i - 1, j - 1] = hcore[j - 1, i - 1] = v
            else:
                i, j, k, l = i - 1, j - 1, k - 1, l - 1
                for a, b, c, d in ((i, j, k, l), (j, i, k, l), (i, j, l, k), (j, i, l, k),
                                   (k, l, i, j), (l, k, i, j), (k, l, j, i), (l, k, j, i)):
                    eri[a, b, c, d] = v
        return cls.from_spatial(hcore, eri, noa, nob, ecore, **kw)

    @classmethod
    def hubbard_1d(
        cls, nsites: int, noa: int, nob: int, t: float = 1.0, u: float = 4.0,
        pbc: bool = False, **kw,
    ) -> "System":
        hcore, eri = ints.hubbard_1d(nsites, t, u, pbc)
        return cls.from_spatial(hcore, eri, noa, nob, 0.0, **kw)
