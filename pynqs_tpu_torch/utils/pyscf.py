"""PySCF ingestion (host side, imported only when called).

Counterpart of ``pynqs_tpu/utils/pyscf.py``: molecule -> RHF (optionally
localized orbitals, frozen core folded by ``utils/orbitals.freeze_core``)
-> spin ``System``.  PySCF is not a dependency of the port: without it
``molecule_system`` raises, and everything else takes ``System``s from
.pth or FCIDUMP files.
"""

from __future__ import annotations

from pynqs_tpu_torch.utils.system import System

__all__ = ["molecule_system", "has_pyscf"]


def has_pyscf() -> bool:
    try:
        import pyscf  # noqa: F401

        return True
    except ImportError:
        return False


def molecule_system(
    atom: str,
    basis: str = "sto-3g",
    charge: int = 0,
    spin: int = 0,
    frozen_core: int = 0,
    localize: str | None = None,  # e.g. "meta_lowdin"
    run_fci: bool = False,
) -> System:
    """Molecule -> RHF (optionally localized orbitals) -> spin System,
    with the FCI energy as ``e_ref`` where ``run_fci``."""
    if not has_pyscf():
        raise ImportError(
            "pyscf is not installed in this environment; load integrals "
            "from a .pth/FCIDUMP file instead (System.from_pth / "
            "System.from_fcidump)"
        )
    from pyscf import ao2mo, fci, gto, lo, scf

    mol = gto.M(atom=atom, basis=basis, charge=charge, spin=spin)
    mf = scf.RHF(mol).run()
    mo = mf.mo_coeff
    if localize is not None:
        mo = lo.orth_ao(mol, method=localize)
    norb = mo.shape[1] - frozen_core
    mo_act = mo[:, frozen_core:]
    hcore_ao = mf.get_hcore()
    ecore = float(mol.energy_nuc())
    if frozen_core:
        from pynqs_tpu_torch.utils.orbitals import freeze_core

        h1_full = mo.T @ hcore_ao @ mo
        eri_full = ao2mo.restore(1, ao2mo.kernel(mol, mo), mo.shape[1])
        h1, eri, ecore = freeze_core(h1_full, eri_full, ecore, frozen_core)
    else:
        h1 = mo_act.T @ hcore_ao @ mo_act
        eri = ao2mo.restore(1, ao2mo.kernel(mol, mo_act), norb)
    nelec = mol.nelectron - 2 * frozen_core
    noa = (nelec + mol.spin) // 2
    nob = nelec - noa
    e_ref = None
    if run_fci:
        e_ref = float(fci.FCI(mf).kernel(h1, eri, norb, (noa, nob), ecore=ecore)[0])
    return System.from_spatial(h1, eri, noa, nob, ecore, e_ref=e_ref)
