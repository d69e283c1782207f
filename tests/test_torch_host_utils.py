"""The host utilities against the JAX package, on the CPU:
``utils/memory.auto_eloc_batch`` (equal at given budgets, and the 4 GiB
default where a CPU device has no memory stats), the native enumerator
(``native.fci_space_bits`` through ``utils/fci.fci_bits`` above 4096
determinants, and ``pack_bits_u32``, equal to the JAX package's, the
library built into ``build/`` and its calls counted), ``utils/tools``,
``utils/plotting`` and the import gate of ``utils/pyscf``."""

import os

import numpy as np
import pytest

from pynqs_tpu import native as jnative
from pynqs_tpu.utils import fci as jfci
from pynqs_tpu.utils import memory as jmemory
from pynqs_tpu.utils import plotting as jplotting
from pynqs_tpu.utils import pyscf as jpyscf

from pynqs_tpu_torch import native
from pynqs_tpu_torch.ops.cuda_build import BUILD_DIR
from pynqs_tpu_torch.utils import fci, memory, plotting, pyscf, tools


def test_auto_eloc_batch_equals_jax():
    assert memory.device_memory_stats("cpu") == {} == jmemory.device_memory_stats()
    for n, n_sd, sorb in ((1 << 20, 7875, 40), (3000, 100, 12), (10, 7875, 40)):
        for budget in (None, 1 << 20, 123_456_789, 80 << 30):
            got = memory.auto_eloc_batch(n, n_sd, sorb, budget_bytes=budget, device="cpu")
            assert got == jmemory.auto_eloc_batch(n, n_sd, sorb, budget_bytes=budget)
    lines = []
    with memory.MemoryTrack("x", device="cpu"):
        lines.append(1)
    assert lines == [1]


def test_native_fci_bits_equals_jax():
    n0 = native.CALLS.n
    got = fci.fci_bits(20, 4, 4)  # C(10, 4)^2 = 44,100 determinants
    assert got.shape == (44100, 20)
    assert native.available() and native.CALLS.n == n0 + 1
    assert os.path.dirname(native.build()) == BUILD_DIR
    np.testing.assert_array_equal(got, jfci.fci_bits(20, 4, 4))
    np.testing.assert_array_equal(got, jnative.fci_space_bits(20, 4, 4))
    np.testing.assert_array_equal(got, fci.python_fci_bits(20, 4, 4))
    small = fci.fci_bits(12, 3, 3)  # 400: the Python enumeration
    assert native.CALLS.n == n0 + 1
    np.testing.assert_array_equal(small, jfci.fci_bits(12, 3, 3))
    rng = np.random.default_rng(0)
    bits = (rng.random((300, 70)) < 0.4).astype(np.int8)
    np.testing.assert_array_equal(native.pack_bits_u32(bits), jnative.pack_bits_u32(bits))
    assert native.CALLS.n == n0 + 2


def test_repro_header_and_dump_input(tmp_path, capsys):
    head = tools.repro_header()
    assert "pynqs_tpu_torch git=" in head and "torch " in head and "cards=" in head
    script = tmp_path / "run.py"
    script.write_text("print('hello')\n")
    out = tools.dump_input(script_path=str(script))
    assert out.startswith(head.split("\n")[0]) and "----- input script -----" in out
    assert "print('hello')" in capsys.readouterr().out


def test_plot_energy_history_as_jax(tmp_path):
    pytest.importorskip("matplotlib")
    h = -1.0 - np.exp(-np.arange(300) / 50.0)
    for mod, name in ((plotting, "port.png"), (jplotting, "jax.png")):
        path = mod.plot_energy_history(h, e_ref=-2.0, path=str(tmp_path / name), tail=100)
        assert os.path.getsize(path) > 1000


def test_pyscf_gate_as_jax():
    assert pyscf.has_pyscf() == jpyscf.has_pyscf()
    if not pyscf.has_pyscf():
        with pytest.raises(ImportError, match="pyscf is not installed"):
            pyscf.molecule_system("H 0 0 0; H 0 0 0.74")
