"""Port parity of the training run's sampler pieces against the JAX
package: exact |ψ|² weights, the adaptive sample count
(``target_unique``), the DFS split-depth rule and its measured
profile."""

from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.sampler import ar as jar
from pynqs_tpu.sampler import ar_sampler as jars

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.sampler import ar as tar
from pynqs_tpu_torch.sampler import ar_sampler as tars
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.utils.fci import fci_bits


def test_exact_weights_equal_the_jax_samplers():
    """Same rows, counts (dead rows included) and parameters: the port's
    exact weights against the JAX sampler's own expression on JAX's
    ``model.log_psi``, to 1e-12."""
    jm = JModel(8, 2, 2, dcut=4, phase_mode="arg", norm_mode="mpsrnn")
    params = jm.init(jax.random.PRNGKey(1))
    tm = GraphMPSRNN(8, 2, 2, dcut=4, phase_mode="arg", norm_mode="mpsrnn", device="cpu")
    tm.load_numpy_params({k: np.asarray(v) for k, v in params.items()})
    s_ct = ARSampler(8, 2, 2, n_sample=300, capacity=40)
    b_ct, w_ct, _ = s_ct.sample(tm, torch.Generator().manual_seed(3))
    b_ex, w_ex, _ = replace(s_ct, exact_weights=True).sample(tm, torch.Generator().manual_seed(3))
    assert torch.equal(b_ct, b_ex)
    counts = (w_ct * 300).round().long()
    assert (counts == 0).any() and (counts > 0).sum() > 10

    def fixed(model, params, key, n, capacity):
        return jnp.asarray(b_ct.numpy()), jnp.asarray(counts.numpy(), jnp.int32), 0

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jars, "ar_sampling", fixed)
        js = jars.ARSampler(8, 2, 2, n_sample=300, capacity=40, exact_weights=True)
        _, jw, _, _ = jax.jit(lambda p: js.sample(jm, p, jax.random.PRNGKey(0)))(params)
    np.testing.assert_allclose(w_ex.numpy(), np.asarray(jw), atol=1e-12, rtol=0)
    assert float(w_ex.sum()) == pytest.approx(1.0, abs=1e-12)
    assert torch.equal(w_ex == 0, counts == 0)


@pytest.mark.parametrize("n_sample,target,max_n", [(100, 30, None), (100, 30, 5000),
                                                   (1000, 5, None), (10, 39, 10**6)])
def test_target_unique_stops_where_the_jax_rule_stops(n_sample, target, max_n, monkeypatch):
    """Scripted draws whose live rows grow with n (n // 40, at most the
    capacity 40): the ×10 growth stops at the same n in both packages,
    and the dropped mass is taken against the realized total."""
    C = 40

    def jfake(model, params, key, n, capacity):
        live = jnp.minimum(n // 40, C)
        c = jnp.where(jnp.arange(C) < live, 1, 0).astype(jnp.int32)
        c = c.at[0].add((n - c.sum()).astype(jnp.int32))
        return jnp.zeros((C, 8), jnp.int8), c, 0

    def tfake(model, n, *, capacity, generator):
        c = (torch.arange(C) < min(n // 40, C)).long()
        c[0] += n - c.sum()
        return torch.zeros(C, 8, dtype=torch.int8), c, 0

    monkeypatch.setattr(jars, "ar_sampling", jfake)
    monkeypatch.setattr(tars, "ar_sampling", tfake)
    js = jars.ARSampler(8, 2, 2, n_sample=n_sample, capacity=C, target_unique=target,
                        max_n_sample=max_n)
    _, jc = js._sample_adaptive(JModel(8, 2, 2, dcut=4), None, jax.random.PRNGKey(0))
    ts = ARSampler(8, 2, 2, n_sample=n_sample, capacity=C, target_unique=target,
                   max_n_sample=max_n)
    _, tc = ts._sample_adaptive(None, torch.Generator())
    assert int(tc.sum()) == int(jnp.sum(jc))
    model = GraphMPSRNN(8, 2, 2, dcut=4, device="cpu")
    _, w, diag = ts.sample(model, torch.Generator())
    assert float(diag["dropped_frac"]) == 0.0 and float(w.sum()) == pytest.approx(1.0)


_PROFILES = [
    # (live, kept, n_sample, capacity_root, n_group)
    ([4, 16, 60, 200, 700, 1500], [10**6] * 6, 10**6, 4096, 8),
    ([4, 16, 60, 200, 700, 1500], [10**6] * 3 + [999_990] * 3, 10**6, 4096, 8),
    ([4, 16, 60, 200, 700, 1500], [10**6] * 6, 10**6, 1024, 8),
    ([1, 2, 3, 5, 7, 9], [10**6] * 6, 10**6, 4096, 16),  # none qualifies: the static rule
    ([4, 16, 60, 200, 1100, 1500], [10**6] * 6, 10**6, 4096, 64),
]


@pytest.mark.parametrize("case", range(len(_PROFILES)))
def test_split_depth_rule_matches_jax(case, monkeypatch):
    live, kept, n, croot, ng = _PROFILES[case]
    prof = (np.asarray(live), np.asarray(kept))
    monkeypatch.setattr(jar, "dfs_depth_profile", lambda *a, **k: prof)
    monkeypatch.setattr(tar, "dfs_depth_profile", lambda *a, **k: prof)

    class M:
        sorb, sites_per_step = 40, 2

    jd = jar.tune_dfs_split_depth(M(), None, None, n, capacity=4096, n_group=ng,
                                  capacity_root=croot)
    td = tar.tune_dfs_split_depth(M(), None, n, capacity=4096, n_group=ng,
                                  capacity_root=croot)
    assert td == jd


def test_depth_profile_equals_jax_when_every_prefix_is_live(monkeypatch):
    """sorb 8, 2α2β, n = 1e7: every reachable prefix is live in both
    packages' expansions (as many as the FCI space's distinct prefixes),
    so the profiles are equal, and so is the depth the rule picks."""
    jm = JModel(8, 2, 2, dcut=4, phase_mode="arg", norm_mode="mpsrnn")
    params = jm.init(jax.random.PRNGKey(2))
    tm = GraphMPSRNN(8, 2, 2, dcut=4, phase_mode="arg", norm_mode="mpsrnn", device="cpu")
    tm.load_numpy_params({k: np.asarray(v) for k, v in params.items()})
    jl, jk = jar.dfs_depth_profile(jm, params, jax.random.PRNGKey(0), 10**7,
                                   capacity_root=64)
    tl, tk = tar.dfs_depth_profile(tm, 10**7, capacity_root=64,
                                   generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tk, jk)
    space = fci_bits(8, 2, 2)
    assert list(tk) == [10**7] * 3
    assert list(tl) == [len({r[:2 * d].tobytes() for r in space}) for d in (1, 2, 3)]
    d, live, _ = tar.tune_dfs_split_depth(tm, torch.Generator().manual_seed(0), 10**7,
                                          capacity=64, n_group=4, return_profile=True)
    np.testing.assert_array_equal(live, jl)
    monkeypatch.setattr(jar, "dfs_depth_profile", lambda *a, **k: (jl, jk))
    assert d == jar.tune_dfs_split_depth(jm, params, None, 10**7, capacity=64, n_group=4)
