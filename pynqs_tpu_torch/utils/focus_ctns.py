"""Raw FOCUS CTNS binary -> Graph-MPS-RNN warm start.

Counterpart (a copy of the numpy reader) of
``pynqs_tpu/utils/focus_ctns.py``: ``read_ctns_sites`` reads the
block-sparse ``rcanon_isweep*.bin`` files that FOCUS's DMRG writes,
``ctns_state_dict`` re-lays the dense sites out in the converted-file
structure, and ``load_focus_ctns_mpsrnn`` returns the parameter tree
through the port's ``mps_import.mpsrnn_params_from_state_dict`` (JAX
layout and key names; load it with ``GraphMPSRNN.load_numpy_params``).
``write_ctns_sites`` writes the same layout, for tests and for
``chip_smoke.py``, which have no FOCUS output to read.

File layout (little-endian):

  int32 ntotal                      # number of site tensors
  repeat ntotal times (sites stored LAST-to-FIRST, right canonical):
    int32  rows;  int32 qrow[rows, 3]    # (N, Sz, deg) row sectors
    int32  cols;  int32 qcol[cols, 3]
    int32  mids;  int32 qmid[mids, 3]    # physical (4-dim) sectors
    uint64 offset[rows*cols*mids]        # 1-based into data; 0 = zero
                                         # block; C-order (r, c, m)
    uint64 size;  float64 data[size]     # blocks stored (m, c, r)
                                         # C-order at each offset

Dense site tensors are [left bond, physical n, right bond] (lnr), first
site first.  The model's bond dimension ``dcut`` must be at least the
file's largest bond: DMRG states of bond dimension 200-500 need the
tensor-core kernel's widths above 128 (``ops/fused_rnn.mma_passes``).
"""

from __future__ import annotations

import struct

import numpy as np

from pynqs_tpu_torch.utils.mps_import import mpsrnn_params_from_state_dict

__all__ = [
    "read_ctns_sites",
    "ctns_state_dict",
    "load_focus_ctns_mpsrnn",
    "write_ctns_sites",
]


def _read_tensor3(buf: memoryview, off: int, dtype) -> tuple[np.ndarray, int]:
    """One block-sparse site tensor -> dense [l, n, r] (lnr), new offset."""

    def _i32(o):
        return struct.unpack_from("<i", buf, o)[0], o + 4

    def _arr(o, dt, count):
        a = np.frombuffer(buf, dtype=dt, count=count, offset=o)
        return a, o + a.nbytes

    rows, off = _i32(off)
    qrow, off = _arr(off, np.int32, 3 * rows)
    cols, off = _i32(off)
    qcol, off = _arr(off, np.int32, 3 * cols)
    mids, off = _i32(off)
    qmid, off = _arr(off, np.int32, 3 * mids)
    offset, off = _arr(off, np.uint64, rows * cols * mids)
    offset = offset.reshape(rows, cols, mids)
    size = struct.unpack_from("<Q", buf, off)[0]
    off += 8
    data, off = _arr(off, dtype, size)
    drow, dcol, dmid = qrow.reshape(rows, 3)[:, 2], qcol.reshape(cols, 3)[:, 2], \
        qmid.reshape(mids, 3)[:, 2]
    # dense assembly in (mid, col, row), then transposed to (row, mid, col)
    dt = np.zeros((dmid.sum(), dcol.sum(), drow.sum()), dtype=data.dtype)
    orow = np.concatenate([[0], np.cumsum(drow)])
    ocol = np.concatenate([[0], np.cumsum(dcol)])
    omid = np.concatenate([[0], np.cumsum(dmid)])
    for r in range(rows):
        for c in range(cols):
            for m in range(mids):
                o = int(offset[r, c, m])
                if o == 0:
                    continue
                dr, dc, dm = int(drow[r]), int(dcol[c]), int(dmid[m])
                blk = data[o - 1: o - 1 + dr * dc * dm].reshape(dm, dc, dr)
                dt[omid[m]: omid[m] + dm, ocol[c]: ocol[c] + dc, orow[r]: orow[r] + dr] = blk
    return dt.transpose(2, 0, 1).copy(), off


def read_ctns_sites(path: str, dtype=np.float64) -> list[np.ndarray]:
    """Dense MPS site tensors [l, n, r] in first-to-last site order."""
    with open(path, "rb") as f:
        raw = memoryview(f.read())
    ntotal = struct.unpack_from("<i", raw, 0)[0]
    off = 4
    sites: list[np.ndarray] = []
    for _ in range(ntotal):
        t, off = _read_tensor3(raw, off, dtype)
        sites.append(t)
    sites.reverse()  # stored right canonical, last site first
    return sites


# FOCUS physical-index order is (0, 2, a, b); the MPS-RNN convention is
# (0, a, b, 2), i.e. x = n_alpha + 2 n_beta.  new[k] = old[_PHYS[k]].
_PHYS = np.array([0, 2, 3, 1])


def ctns_state_dict(sites: list[np.ndarray], phys=None) -> dict:
    """Dense site tensors -> the converted-file structure:

      params_M.all_sites: list of [4, Dout, Din, 2] (im = 0), rotated so
        site 0's tensor (the boundary M) is the last entry;
      params_w.all_sites [norb, dcut, 2]: zero except w[-1] = 1;
      params_c.all_sites [norb, 2]: zeros.

    ``phys``: the physical-index permutation applied per site (default
    FOCUS's order ``_PHYS``; an identity for tensors already in the
    converted 4-basis order, as the Renormalizer path has them)."""
    if phys is None:
        phys = _PHYS
    M_list = []
    for t in sites:
        m = np.ascontiguousarray(np.transpose(t[:, phys, :], (1, 2, 0)))  # [4, Dout, Din]
        M_list.append(np.stack([m, np.zeros_like(m)], axis=-1))
    M_list = M_list[1:] + M_list[:1]
    norb = len(sites)
    dcut = max(max(m.shape[1], m.shape[2]) for m in M_list)
    w = np.zeros((norb, dcut, 2))
    w[-1, :, 0] = 1.0
    return {
        "params_M.all_sites": M_list,
        "params_w.all_sites": w,
        "params_c.all_sites": np.zeros((norb, 2)),
    }


def load_focus_ctns_mpsrnn(path: str, model, dtype=np.float64) -> dict:
    """The parameter tree of a chain ``GraphMPSRNN`` (arg phase, mpsrnn
    gauge) warm-started from a raw FOCUS CTNS binary (e.g.
    ``rcanon_isweep49.bin``): the raw-file equivalent of
    ``mps_import.load_focus_mpsrnn``."""
    return mpsrnn_params_from_state_dict(ctns_state_dict(read_ctns_sites(path, dtype)), model)


def write_ctns_sites(path: str, sites: list[np.ndarray], sectors: list[tuple]) -> None:
    """Write dense sites [l, n, r] (first site first) in the binary layout
    above.  ``sectors[i]`` = (row, col, mid) degeneracy lists of site i,
    summing to its l, r and n; each sector gets quantum numbers (k, 0,
    deg), k its index.  A block that is zero is stored as offset 0."""
    out = [struct.pack("<i", len(sites))]
    for t, (drow, dcol, dmid) in zip(sites[::-1], sectors[::-1]):
        drow, dcol, dmid = (np.asarray(v, np.int64) for v in (drow, dcol, dmid))
        if (drow.sum(), dmid.sum(), dcol.sum()) != t.shape:
            raise ValueError(f"sectors {drow.sum(), dmid.sum(), dcol.sum()} do not cover "
                             f"a site of shape {t.shape}")
        for deg in (drow, dcol, dmid):
            q = np.stack([np.arange(len(deg)), np.zeros(len(deg), np.int64), deg], 1)
            out += [struct.pack("<i", len(deg)), q.astype("<i4").tobytes()]
        orow, ocol, omid = (np.concatenate([[0], np.cumsum(v)]) for v in (drow, dcol, dmid))
        offset = np.zeros((len(drow), len(dcol), len(dmid)), np.uint64)
        data, n = [], 0
        for r in range(len(drow)):
            for c in range(len(dcol)):
                for m in range(len(dmid)):
                    blk = t[orow[r]: orow[r + 1], omid[m]: omid[m + 1], ocol[c]: ocol[c + 1]]
                    if not blk.any():
                        continue
                    offset[r, c, m] = n + 1
                    blk = np.ascontiguousarray(blk.transpose(1, 2, 0), "<f8").ravel()  # (m, c, r)
                    data.append(blk)
                    n += blk.size
        out += [offset.astype("<u8").tobytes(), struct.pack("<Q", n)]
        out += [b.tobytes() for b in data]
    with open(path, "wb") as f:
        f.write(b"".join(out))
