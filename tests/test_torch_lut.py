"""Port parity: packed determinants, the lookup table and the forward dedup.

``pack_bits``/``unpack_bits``/``popcount_u32``/``compare_keys_*`` word for
word against the JAX package at one word-pair (sorb 40) and three words
(sorb 70); ``sort_onv``, ``unique_onv``, ``lut_search`` and
``WavefunctionLUT`` exactly, with duplicates, dead rows and misses;
``dedup_eval`` (f64, 1e-12, the same distinct count; the port raises on
overflow where JAX returns NaN); the REDUCE local energy and a VMC step
with ``dedup_unique_max`` equal to themselves without it for the same
generator, and the REDUCE with dedup equal to the JAX package's where
k_det = n_sd makes it deterministic (f64, 1e-10)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pynqs_tpu.energy.eloc import dedup_eval as jdedup_eval
from pynqs_tpu.energy.eloc import local_energy_reduce as jreduce
from pynqs_tpu.models.graph_mps_rnn import GraphMPSRNN as JModel
from pynqs_tpu.ops import lut as jlut
from pynqs_tpu.ops import onv as jonv
from pynqs_tpu.utils import System as JSystem

from pynqs_tpu_torch.energy.eloc import dedup_eval, local_energy_reduce, reduce_unique_count
from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN
from pynqs_tpu_torch.ops import lut, onv
from pynqs_tpu_torch.ops.fused_rnn_prefix import ReducePrefixForward
from pynqs_tpu_torch.ops.integrals import triangle_size
from pynqs_tpu_torch.optim.vmc import VMC, VMCConfig
from pynqs_tpu_torch.sampler.ar_sampler import ARSampler
from pynqs_tpu_torch.utils import fci
from pynqs_tpu_torch.utils.system import System

SORB, NOA, NOB = 8, 2, 2


def _rows(rng, n, sorb, n_distinct):
    """n rows drawn from n_distinct random determinants (duplicates)."""
    base = (rng.random((n_distinct, sorb)) < 0.4).astype(np.int8)
    base[:, -1] = 1  # the top word is used
    return base[rng.integers(0, n_distinct, n)]


def _words(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("sorb", [40, 70])
def test_packed_words_equal_jax(sorb):
    rng = np.random.default_rng(sorb)
    bits = _rows(rng, 300, sorb, 200)
    w = onv.pack_bits(torch.as_tensor(bits))
    jw = jonv.pack_bits(jnp.asarray(bits))
    assert onv.n_words32(sorb) == jonv.n_words32(sorb) == w.shape[-1]
    np.testing.assert_array_equal(w.numpy(), _words(jw))
    np.testing.assert_array_equal(onv.unpack_bits(w, sorb).numpy(), bits)
    np.testing.assert_array_equal(onv.unpack_bits(w, sorb).numpy(),
                                  np.asarray(jonv.unpack_bits(jw, sorb)))
    np.testing.assert_array_equal(onv.popcount_u32(w).numpy(),
                                  np.asarray(jonv.popcount_u32(jw)))
    a, b = w[:150], w[150:]
    for f, jf in ((onv.compare_keys_lt, jonv.compare_keys_lt),
                  (onv.compare_keys_le, jonv.compare_keys_le)):
        np.testing.assert_array_equal(f(a, b).numpy(), np.asarray(jf(jw[:150], jw[150:])))
        np.testing.assert_array_equal(f(a, a).numpy(), np.asarray(jf(jw[:150], jw[:150])))
    key = lut.row_keys(w)  # one int64 per row up to two words, in the words' order
    if sorb <= 64:
        ref = (_words(jw)[:, 1] - (1 << 31)) * (1 << 32) + _words(jw)[:, 0]
        np.testing.assert_array_equal(key.numpy(), ref)
        assert (np.diff(key.numpy()[np.lexsort(_words(jw).T)]) >= 0).all()
    else:
        assert key is None


@pytest.mark.parametrize("sorb", [40, 70])
def test_sort_unique_search_and_lookup_equal_jax(sorb):
    rng = np.random.default_rng(1 + sorb)
    bits = _rows(rng, 400, sorb, 120)
    packed = onv.pack_bits(torch.as_tensor(bits))
    jpacked = jonv.pack_bits(jnp.asarray(bits))
    pay = np.arange(400)
    sp, spay = lut.sort_onv(packed, torch.as_tensor(pay))
    jsp, jspay = jlut.sort_onv(jpacked, jnp.asarray(pay))
    np.testing.assert_array_equal(sp.numpy(), _words(jsp))
    np.testing.assert_array_equal(spay.numpy(), np.asarray(jspay))  # stable: ties by position

    counts = rng.integers(0, 4, 400)  # a quarter of the rows dead
    u, c, n = lut.unique_onv(packed, torch.as_tensor(counts))
    ju, jc, jn = jlut.unique_onv(jpacked, jnp.asarray(counts))
    assert n == int(jn) and 0 < n < 120
    np.testing.assert_array_equal(u.numpy(), _words(ju))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))

    # the table: the distinct live keys; queries hit, repeat and miss
    table = u[:n]
    queries = torch.cat([packed, onv.pack_bits(torch.as_tensor(_rows(rng, 100, sorb, 100)))])
    idx, found = lut.lut_search(table, queries)
    jidx, jfound = jlut.lut_search(jnp.asarray(table.numpy().astype(np.uint32)),
                                   jnp.asarray(queries.numpy().astype(np.uint32)))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(idx.numpy()[found.numpy()], np.asarray(jidx)[np.asarray(jfound)])
    assert found.numpy()[400:].sum() < 100 and found.numpy()[:400].any()

    vals = rng.standard_normal((n, 2))
    rows_t = onv.unpack_bits(table, sorb)
    t_lut = lut.WavefunctionLUT.build(rows_t.flip(0), torch.as_tensor(vals[::-1].copy()))
    j_lut = jlut.WavefunctionLUT.build(jnp.asarray(rows_t.numpy()[::-1]),
                                       jnp.asarray(vals[::-1]))
    q_rows = onv.unpack_bits(queries, sorb)
    v, f = t_lut.lookup_packed(queries, fill=-7.0)
    jv, jf = j_lut.lookup_packed(jnp.asarray(queries.numpy().astype(np.uint32)),
                                 fill=-7.0, method="bisect")
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    v, f = t_lut.lookup(q_rows)
    jv, jf = j_lut.lookup(jnp.asarray(q_rows.numpy()))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    with pytest.raises(ValueError, match="lookup method"):
        t_lut.lookup_packed(queries, method="onehot")


def _system(dtype=np.float64, seed=4):
    rng = np.random.default_rng(seed)
    h1e = rng.standard_normal((SORB, SORB)) * 0.3
    h1e = (h1e + h1e.T) / 2
    h2e = rng.standard_normal(triangle_size(SORB)) * 0.1
    return (System.from_integrals(h1e, h2e, SORB, NOA, NOB, dtype=dtype),
            JSystem.from_integrals(h1e, h2e, SORB, NOA, NOB, dtype=dtype))


def _models(seed=1, dtype=torch.float64):
    jm = JModel(SORB, NOA, NOB, dcut=4, phase_mode="arg", norm_mode="mpsrnn")
    params = jm.init(jax.random.PRNGKey(seed))
    tm = GraphMPSRNN(SORB, NOA, NOB, dcut=4, phase_mode="arg", norm_mode="mpsrnn",
                     dtype=dtype, device="cpu")
    tm.load_numpy_params({k: np.asarray(v) for k, v in params.items()})
    return jm, params, tm


def _rowwise(model):
    """model.log_psi one row at a time: its rounding does not follow the
    batch, so a deduplicated forward gives the same values bit for bit
    (a batched CPU matmul may round a row differently at another batch
    size, by an ulp)."""
    return lambda b: torch.cat([model.log_psi(b[i:i + 1]) for i in range(b.shape[0])])


def test_dedup_eval_equals_jax_and_raises_on_overflow():
    jm, params, tm = _models()
    space = fci.fci_bits(SORB, NOA, NOB)
    rng = np.random.default_rng(0)
    flat = space[rng.integers(0, 20, 500)]  # 500 rows of at most 20 determinants
    lp, n = dedup_eval(tm.log_psi, torch.as_tensor(flat), 24)
    jded = jax.jit(lambda b, cap: jdedup_eval(lambda x: jm.log_psi(params, x), b, cap),
                   static_argnums=1)
    jlp, jn = jded(jnp.asarray(flat), 24)
    assert n == int(jn) == len(np.unique(flat, axis=0))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-12, rtol=0)
    np.testing.assert_allclose(lp.numpy(), tm.log_psi(torch.as_tensor(flat)).detach().numpy(),
                               atol=1e-12, rtol=0)
    # one below the count: the port raises where the JAX package writes NaN
    with pytest.raises(OverflowError, match="n_unique_max"):
        dedup_eval(tm.log_psi, torch.as_tensor(flat), n - 1)
    jlp, _ = jded(jnp.asarray(flat), n - 1)
    assert np.isnan(np.asarray(jlp)).any()


def test_reduce_with_dedup_equals_itself_without_and_jax():
    """The same generator state: bit for bit with and without the cap; at
    k_det = n_sd (deterministic) equal to the JAX REDUCE with dedup."""
    ts, js = _system()
    jm, params, tm = _models(2)
    space = fci.fci_bits(SORB, NOA, NOB)
    bits = torch.as_tensor(space[np.random.default_rng(1).integers(0, len(space), 48)])
    tabs, table = ts.tables("cpu"), ts.excitation
    kw = dict(k_det=6, n_stoch=8, batch=16, hpair=tabs.hpair_sect)
    fwd = _rowwise(tm)
    a = local_energy_reduce(fwd, bits, tabs.astuple(), table,
                            torch.Generator().manual_seed(3), **kw)
    b = local_energy_reduce(fwd, bits, tabs.astuple(), table,
                            torch.Generator().manual_seed(3), dedup_unique_max=10_000, **kw)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    counts = reduce_unique_count(bits, tabs.astuple(), table,
                                 torch.Generator().manual_seed(3), **kw)
    assert len(counts) == 3 and all(0 < c <= 16 * (1 + 6 + 8) for c in counts)
    local_energy_reduce(tm.log_psi, bits, tabs.astuple(), table,
                        torch.Generator().manual_seed(3), dedup_unique_max=max(counts), **kw)
    with pytest.raises(OverflowError):
        local_energy_reduce(tm.log_psi, bits, tabs.astuple(), table,
                            torch.Generator().manual_seed(3),
                            dedup_unique_max=max(counts) - 1, **kw)
    with pytest.raises(ValueError, match="exclusive"):
        local_energy_reduce(tm.log_psi, bits, tabs.astuple(), table,
                            torch.Generator().manual_seed(3), dedup_unique_max=100,
                            prefix_fwd=ReducePrefixForward(tm), **kw)

    n_sd = table.n_sd
    ex = local_energy_reduce(tm.log_psi, bits, tabs.astuple(), table,
                             torch.Generator().manual_seed(4), k_det=n_sd, n_stoch=4,
                             batch=16, hpair=tabs.hpair_sect, dedup_unique_max=10_000)
    jops = tuple(jnp.asarray(np.asarray(x)) for x in js.tables.astuple())
    jex = jreduce(lambda b: jm.log_psi(params, b), jnp.asarray(bits.numpy()), jops,
                  js.excitation, jax.random.PRNGKey(0), k_det=n_sd, n_stoch=4, batch=16,
                  hpair=js.tables.hpair_best, dedup_unique_max=10_000)
    np.testing.assert_allclose(ex.numpy(), np.asarray(jex), atol=1e-10, rtol=0)


def test_vmc_step_with_dedup_equals_step_without():
    ts, _ = _system()
    out = []
    for cap in (None, 10_000):
        _, _, tm = _models(5)
        sampler = ARSampler(SORB, NOA, NOB, n_sample=2000, capacity=36)
        v = VMC(tm, ts, sampler, VMCConfig(lr=1e-2, eloc_method="reduce", eloc_k_det=4,
                                           eloc_n_stoch=4, eloc_batch=8, eloc_dedup_max=cap))
        v._eloc_forward = lambda tm=tm: _rowwise(tm)
        info = v.step(torch.Generator().manual_seed(6), 1.0)
        out.append((float(info["energy"]), {k: p.detach().clone()
                                            for k, p in tm.named_parameters()}))
    assert out[0][0] == out[1][0]
    for k, p in out[0][1].items():
        assert torch.equal(p, out[1][1][k]), k
    _, _, tm = _models(5)
    v = VMC(tm, ts, ARSampler(SORB, NOA, NOB, n_sample=2000, capacity=36),
            VMCConfig(eloc_method="reduce", eloc_dedup_max=100, eloc_prefix=True))
    with pytest.raises(ValueError, match="exclusive"):
        v.step(torch.Generator().manual_seed(6), 1.0)
