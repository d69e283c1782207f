"""The fused forward once per distinct row, on the CPU: from
``fused_rnn.DEDUP_MIN_ROWS`` rows on, ``graph_mpsrnn_logpsi_fused`` runs
the forward on the distinct rows alone and gives every row, bit for bit,
what the call gives it with the dedup off; an empty batch and a batch
under the threshold keep the forward on every row.  Rows wider than two
32-bit words, which have no int64 key, sort their packed words;
``onv.pack_bits``' fold is held to the plain sum of powers of two.  The
card's kernel is held to the same in tests/test_torch_gpu.py."""

import pytest
import torch
import torch.nn.functional as F

from pynqs_tpu_torch.models.graph_mps_rnn import GraphMPSRNN, grid_snake_graph
from pynqs_tpu_torch.ops import fused_rnn, onv
from pynqs_tpu_torch.utils import fci

OFF = 1 << 62  # a threshold no batch reaches


def _forward(model, bits, mm, monkeypatch, threshold):
    """(the fused forward's rows, the row counts its forward ran on)."""
    ran = []
    plain = fused_rnn.graph_mpsrnn_logpsi_fused_plain

    def counted(model, rows, **kw):
        ran.append(rows.shape[0])
        return plain(model, rows, **kw)

    with monkeypatch.context() as m:
        m.setattr(fused_rnn, "DEDUP_MIN_ROWS", threshold)
        m.setattr(fused_rnn, "graph_mpsrnn_logpsi_fused_plain", counted)
        return fused_rnn.graph_mpsrnn_logpsi_fused(model, bits, matmul_dtype=mm), ran


@pytest.mark.parametrize("mm", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dedup_gives_every_row_what_the_forward_gives_it(mm, monkeypatch):
    g = torch.Generator().manual_seed(0)
    model = GraphMPSRNN(12, 3, 3, dcut=6, graph=grid_snake_graph(3, 2), use_tensor=True,
                        dcut_cmpr=4, device="cpu", generator=g)
    dets = torch.as_tensor(fci.fci_bits(12, 3, 3))
    # 40 distinct rows, each planted 1 to 7 times, in a mixed order
    reps = torch.randint(1, 8, (40,), generator=g)
    flat = dets[:40].repeat_interleave(reps, 0)
    flat = flat[torch.randperm(flat.shape[0], generator=g)]
    monkeypatch.setattr(fused_rnn, "PACK_ROWS", 16)  # the packing in several blocks
    for bits, n_ran in ((flat, [40]), (flat[:0], [0]), (flat[:5], [5])):
        off, ran_off = _forward(model, bits, mm, monkeypatch, OFF)
        on, ran_on = _forward(model, bits, mm, monkeypatch, 6)
        assert ran_off == [bits.shape[0]] and ran_on == n_ran
        assert on.shape == (bits.shape[0], 2) and torch.equal(on, off)
    # rows wider than two 32-bit words: 35 orbitals, the packed words sorted as they are
    wide_model = GraphMPSRNN(70, 2, 2, dcut=4, device="cpu", generator=g)
    wide = torch.zeros(9, 70, dtype=torch.int8)
    for r in range(9):
        occ = torch.randperm(35, generator=g)
        wide[r, 2 * occ[:2]] = 1
        wide[r, 2 * occ[2:4] + 1] = 1
    wide = wide[torch.randint(9, (50,), generator=g)]
    n_u = torch.unique(wide, dim=0).shape[0]
    first, inverse = fused_rnn.distinct_rows(wide)
    assert first.shape == (n_u,) and torch.equal(wide[first][inverse], wide)
    # onv.pack_bits' multiply fold gives each word as the sum of its bits'
    # powers of two, at widths of one, two and three words and any leading shape
    dense = torch.randint(0, 2, (40, 64), generator=g, dtype=torch.int8)
    for b in (flat, wide, dense, dense[:, :33], torch.ones(3, 64, dtype=torch.int8),
              dense.view(5, 8, 64), dense[0], dense[:0]):
        nw = onv.n_words32(b.shape[-1])
        words = F.pad(b.long(), (0, 32 * nw - b.shape[-1])).reshape(b.shape[:-1] + (nw, 32))
        assert torch.equal(onv.pack_bits(b), (words << torch.arange(32)).sum(-1))
    off, _ = _forward(wide_model, wide, mm, monkeypatch, OFF)
    on, ran_on = _forward(wide_model, wide, mm, monkeypatch, 1)
    assert ran_on == [n_u] and torch.equal(on, off)
