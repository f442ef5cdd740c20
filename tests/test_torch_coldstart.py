"""A property of the receive design that both packages share, pinned on one
capture: the frame a channel pops while it acquires from a cold start can
decode cleanly into the complement of what was sent.  `chip_smoke.py` counts
such frames apart; this test is why it may.
"""

import numpy as np

from _torch_port import frames_of, jnp_tree
from xritdemod_tpu.models.decoder import DecoderConfig as JDecoderConfig
from xritdemod_tpu.models.demodulator import DemodConfig as JDemodConfig
from xritdemod_tpu.models.receiver import FusedReceiver as JFusedReceiver
from xritdemod_tpu_torch import tx
from xritdemod_tpu_torch.models.decoder import DecoderConfig
from xritdemod_tpu_torch.models.demodulator import DemodConfig
from xritdemod_tpu_torch.models.receiver import FusedReceiver

CHANNELS, T = 2, 1 << 15


def _frame_lists(outs):
    lists = [[] for _ in range(CHANNELS)]
    for batch, _, _ in outs:
        for c, fr in enumerate(frames_of(batch)):
            lists[c] += fr
    return lists


def test_cold_start_frame_can_be_the_complement_in_both():
    """A property of the design, shared by both packages: the frame a channel
    pops while it acquires from a cold start can decode cleanly into the
    COMPLEMENT of what was sent (sync marker read upright, the Costas loop
    then settles half a cycle away; the code is transparent and the
    complement of an RS codeword is a codeword).  This capture shows it on
    channel 0, and channel 1 comes out upright; both receivers must return
    the very same frames."""
    cfg = DemodConfig.lrit(sample_rate=1_250_000)
    sigs, vcdus = [], []
    for s in range(CHANNELS):
        v = tx.make_vcdus(3, scid=13, vcid=s + 1, counter0=1000 * (s + 1),
                          rng=np.random.default_rng(20240 + s))
        sym = tx.encode_stream(v, lrit=True, rng=np.random.default_rng(20250 + s))
        sigs.append(tx.modulate(
            sym, cfg, np.random.default_rng(20260 + s), freq_offset=(s - 1.5) * 2e-4,
            phase=0.4 + 0.9 * s, amp=0.3, noise=0.0424))
        vcdus.append(v)
    jrx = JFusedReceiver(
        JDemodConfig.lrit(sample_rate=1_250_000), JDecoderConfig(mode="lrit"),
        channels=CHANNELS, block_len=T,
    )
    trx = FusedReceiver(cfg, DecoderConfig(mode="lrit"), channels=CHANNELS,
                        block_len=T, device="cpu")
    jst, tst = jrx.init_state(), trx.init_state()
    jouts, touts = [], []
    for b in range(3):              # the first frame of each channel pops in block 2
        x = np.stack([s[b * T:(b + 1) * T] for s in sigs])
        jbatch, jok, jovf, jst = jrx.step(x, jst)
        tbatch, tok, tovf, tst = trx.step(x, tst)
        jouts.append((jnp_tree(jbatch), np.asarray(jok), np.asarray(jovf)))
        touts.append((tbatch, tok.numpy(), tovf.numpy()))
    jl, tl = _frame_lists(jouts), _frame_lists(touts)
    assert jl == tl
    assert [len(l) for l in tl] == [1, 1]
    (_, _, first0), (vcid1, ctr1, first1) = tl[0][0], tl[1][0]
    assert first0 == (~vcdus[0][0]).tobytes()
    assert (vcid1, ctr1, first1) == (2, 2000, vcdus[1][0].tobytes())
    rs = touts[2][0].rs_errors.numpy()
    assert (rs[0, 0] > 0).all() and (rs[1, 0] == 0).all()
    np.testing.assert_array_equal(rs, np.asarray(jouts[2][0].rs_errors))
