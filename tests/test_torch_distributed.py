"""The port's multi-process runtime (`xritdemod_tpu_torch/parallel/distributed.py`)
on the CPU: `initialize`, `make_host_mesh` and the three `Distributed*` classes
in one process against their unsharded counterparts (and, for the channel
axis, the JAX package's `DistributedChannelReceiver` on its 8 virtual CPU
devices), and one real two-process `gloo` run of
`xritdemod_tpu_torch/tools/dist_worker.py` with a `file://` store (no
ports), each rank with one entry of a `"cpu"` mesh.

Tolerances: the channel axis's `valid` equal and soft within 1e-5 (the two
packages' plain chains, as in `tests/test_torch_parallel.py`); the port's
sharded forms against its unsharded ones bit for bit (the same plain
arithmetic, row by row).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port import make_capture
from xritdemod_tpu.models.demodulator import DemodConfig as JDemodConfig
from xritdemod_tpu.parallel.distributed import DistributedChannelReceiver as JDistChannel
from xritdemod_tpu.parallel.distributed import make_host_mesh as jmake_host_mesh
from xritdemod_tpu_torch import tx
from xritdemod_tpu_torch.models.decoder import DecoderConfig
from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator
from xritdemod_tpu_torch.models.receiver import FusedReceiver
from xritdemod_tpu_torch.parallel import distributed as pdist
from xritdemod_tpu_torch.parallel.channels import make_channel_mesh
from xritdemod_tpu_torch.parallel.timeblocks import TimeBlockDemodulator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.inference_mode():
        yield


def test_initialize_without_a_coordinator_is_a_no_op(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert pdist.initialize() is False
    assert not torch.distributed.is_initialized()


def test_initialize_refuses_cards_that_do_not_exist(tmp_path, monkeypatch):
    """`local_device_ids` name CUDA cards; ids past the visible cards (here
    none) or an empty list are refused before any group starts."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for ids in ([2], [0, -1], []):
        with pytest.raises(ValueError, match="local_device_ids"):
            pdist.initialize("127.0.0.1:1", 2, 0, ids, backend="gloo")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="local_device_ids"):
        pdist.initialize(init_method=f"file://{tmp_path}/store", num_processes=1,
                         process_id=0, local_device_ids=[0], backend="gloo")
    assert not torch.distributed.is_initialized()


def test_initialize_needs_an_explicit_backend(tmp_path):
    with pytest.raises(ValueError):
        pdist.initialize(init_method=f"file://{tmp_path}/store", num_processes=1,
                         process_id=0)
    with pytest.raises(ValueError):
        pdist.initialize(init_method=f"file://{tmp_path}/store", num_processes=1,
                         process_id=0, backend="mpi")
    assert not torch.distributed.is_initialized()


def test_make_host_mesh_single_process():
    mesh = pdist.make_host_mesh(["cpu"] * 8)
    assert mesh.shape == {"host": 1, "chip": 8}
    assert mesh.size == 8 and mesh.rank == 0
    assert mesh.local.devices == (CPU,) * 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pdist.make_host_mesh()


def test_distributed_channel_receiver_single_process():
    """(1, 8) mesh, one channel an entry: equal to the unsharded batch and
    to the JAX package's `DistributedChannelReceiver` on a (1, 8) mesh."""
    cfg = DemodConfig.lrit(sample_rate=1_250_000)
    T = 1 << 13
    rx = pdist.DistributedChannelReceiver(cfg, channels_per_device=1, block_len=T,
                                          mesh=pdist.make_host_mesh(["cpu"] * 8))
    assert (rx.channels, rx.channels_local) == (8, 8)
    sig, _ = make_capture(cfg, rx.channels, 2)
    sig = sig[:, :T]
    soft, valid, state = rx.demod_block(sig, rx.init_demod_state())
    assert len(state) == 8
    ref = Demodulator(cfg, block_len=T, device="cpu")
    rs, rv, _ = ref.block_batch(sig, ref.init_state_batch(rx.channels))
    assert torch.equal(valid, rv)
    assert torch.equal(soft, rs)
    jrx = JDistChannel(JDemodConfig.lrit(sample_rate=1_250_000), channels_per_device=1,
                       block_len=T, mesh=jmake_host_mesh())
    js, jv, _ = jrx.demod_block(sig, jrx.init_demod_state())
    np.testing.assert_array_equal(valid.numpy(), jv)
    np.testing.assert_allclose(soft.numpy(), js, atol=1e-5)
    with pytest.raises(ValueError):
        rx.init_tails()


def test_distributed_timeblocks_single_process():
    """One process: the same rows as `TimeBlockDemodulator` over its mesh."""
    cfg = DemodConfig.lrit(sample_rate=1_250_000)
    block, warm = 1 << 14, 4096
    mesh = pdist.make_host_mesh(["cpu"] * 2)
    tb = pdist.DistributedTimeBlockDemodulator(cfg, block_len=block, warmup=warm, mesh=mesh,
                                               decode_overlap=2048)
    sig, _ = make_capture(cfg, 1, 2)
    x = sig[0, : 2 * block]
    soft, valid = tb.process_local(x)
    ref = TimeBlockDemodulator(cfg, make_channel_mesh(["cpu"] * 2, "t"), block_len=block,
                               warmup=warm, decode_overlap=2048)
    rs, rv = ref.process(x)
    assert soft.shape == (2, tb.num_slots)
    assert torch.equal(valid, rv) and torch.equal(soft, rs)
    assert valid[1].sum() > 0


def test_distributed_fused_receiver_single_process():
    """(1, 2) mesh, 2 channels an entry: the same results, every field, as
    one `FusedReceiver(channels=4)` over the first 3 blocks of 2 frames (each
    channel pops its first frame); each entry's state is its own copy."""
    cfg = DemodConfig.lrit(sample_rate=600_000)
    dcfg = DecoderConfig(mode="lrit")
    T = 1 << 14
    vcdus = tx.make_vcdus(2, scid=13, vcid=3, rng=np.random.default_rng(101))
    symbols = tx.encode_stream(vcdus, lrit=True, amp=1.0, rng=np.random.default_rng(102))
    sig = tx.modulate(symbols, cfg, np.random.default_rng(103))
    drx = pdist.DistributedFusedReceiver(cfg, dcfg, channels_per_device=2, block_len=T,
                                         mesh=pdist.make_host_mesh(["cpu"] * 2))
    rx = FusedReceiver(cfg, dcfg, channels=drx.channels, block_len=T, device="cpu")
    dst, ust = drx.init_state(), rx.init_state()
    assert dst[0].ring.data_ptr() != dst[1].ring.data_ptr()
    got_d, got_u = [], []
    for b in range(3):
        x = np.tile(sig[b * T : (b + 1) * T], (drx.channels, 1))
        db, dok, dovf, dst = drx.step(x, dst)
        ub, uok, uovf, ust = rx.step(x, ust)
        assert torch.equal(dok, uok) and torch.equal(dovf, uovf)
        for f in db._fields:
            a, u = getattr(db, f), getattr(ub, f)
            assert (a is None and u is None) or torch.equal(a, u), f
        fok = (db.frame_ok & dok).numpy()
        got_d += [(c, int(db.counter[c, j]), bytes(db.vcdu[c, j].numpy()))
                  for c, j in zip(*np.nonzero(fok))]
    assert len(got_d) >= drx.channels
    assert all(v == bytes(vcdus[ctr]) for _, ctr, v in got_d)


def test_two_process_gloo_receive(tmp_path):
    """Two ranks of `tools/dist_worker.py` (gloo, `file://` store, one
    `"cpu"` entry each: the smallest mesh whose halo crosses the process
    boundary) both print ALL OK: each rank's checks, among them every
    time-block frame its stream spans bit-exact.  (`chip_smoke.py` runs the
    ranks with 2 entries each and holds their time-block frames equal to
    one process's, at full size.)"""
    rate, block = 600_000, 81_920
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "xritdemod_tpu_torch.tools.dist_worker", str(r), "2",
             f"file://{tmp_path}/store", "gloo", "cpu", "1", "--rate", str(rate),
             "--tb-block", str(block), "--tb-out", str(tmp_path / f"tb{r}.json")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=ROOT, env=env, text=True,
        )
        for r in range(2)
    ]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        assert "ALL OK" in out, f"rank {r} incomplete:\n{out}"
    got = {}
    for r in range(2):
        got.update(json.loads((tmp_path / f"tb{r}.json").read_text()))
    # Every block's frames, in stream order: both ranks' blocks decoded.
    assert sorted(got) == ["0", "1"]
    assert sum(len(row) for row in got.values()) >= 3
