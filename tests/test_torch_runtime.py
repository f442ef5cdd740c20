"""The port's runtime layer against the JAX package's, on the CPU: the config
loaders, the `Statistics_st` wire records, the native host library and the
sample rings, checkpoints, metrics, and the command line.
"""

import ast
import os
import shutil
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from _torch_port import jnp_tree, tnp
from xritdemod_tpu.models.demodulator import DemodConfig as JDemodConfig
from xritdemod_tpu.models.demodulator import Demodulator as JDemodulator
from xritdemod_tpu.runtime import checkpoint as jckpt
from xritdemod_tpu.runtime import config as jconfig
from xritdemod_tpu.runtime.statistics import Statistics as JStatistics
from xritdemod_tpu_torch import cli, convert, tx
from xritdemod_tpu_torch.models.demodulator import DemodConfig, Demodulator, quantize_symbols
from xritdemod_tpu_torch.models.receiver import FusedReceiver
from xritdemod_tpu_torch.models.decoder import DecoderConfig
from xritdemod_tpu_torch.runtime import checkpoint, config, native
from xritdemod_tpu_torch.runtime.metrics import TRACE_FILE, PipelineMetrics, trace
from xritdemod_tpu_torch.runtime.statistics import Statistics
from xritdemod_tpu_torch.runtime.symbol_manager import SampleFifo
from xritdemod_tpu_torch.tools import interop_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HAVE_GXX = shutil.which("g++") is not None


# -- config files -------------------------------------------------------------

_DEMOD_FILES = {
    "missing": None,
    "lrit": "mode=lrit\nsampleRate=1250000\n",
    "hrit": "mode=hrit\nsampleRate=3000000\ndecimation=2\n",
    "hrit_preset_overrides": "mode=hrit\nsymbolRate=1000\nrrcAlpha=0.9\n",
    "no_mode_explicit": "symbolRate=500000\nrrcAlpha=0.35\nsampleRate=2000000\n",
    "pll_and_sinc": "# comment\nmode=lrit\npllAlpha=0.002\nclockInterp=sinc\n  \n",
}


@pytest.mark.parametrize("case", sorted(_DEMOD_FILES))
def test_demod_config_files_load_alike(tmp_path, case):
    """Both loaders on the same file give equal configs field by field (the
    port's config has no TPU tuning fields; every field it has is compared)
    and equal parsed keys; a missing file is written, byte-equal."""
    text = _DEMOD_FILES[case]
    paths = [tmp_path / "jax.cfg", tmp_path / "port.cfg"]
    if text is not None:
        for p in paths:
            p.write_text(text)
    jcfg, jp = jconfig.demod_config_from_file(str(paths[0]))
    tcfg, tp = config.demod_config_from_file(str(paths[1]))
    assert isinstance(tcfg, DemodConfig)
    for f in tcfg.__dataclass_fields__:
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.sps == jcfg.sps
    assert tp._data == jp._data
    assert paths[1].read_bytes() == paths[0].read_bytes()
    if text is None:
        assert tp.get("sampleRate") == "3000000" and tcfg.sample_rate == 3_000_000
        assert tp.get("sendConstellation") == "true"


def test_demod_config_invalid_mode_raises(tmp_path):
    p = tmp_path / "x.cfg"
    p.write_text("mode=xrit\n")
    with pytest.raises(ValueError, match="invalid mode"):
        config.demod_config_from_file(str(p))


@pytest.mark.parametrize("text", [None, "mode=hrit\nframesPerBlock=32\n", "display=true\n"])
def test_decoder_config_files_load_alike(tmp_path, text):
    paths = [tmp_path / "jax.cfg", tmp_path / "port.cfg"]
    if text is not None:
        for p in paths:
            p.write_text(text)
    jcfg, jp = jconfig.decoder_config_from_file(str(paths[0]))
    tcfg, tp = config.decoder_config_from_file(str(paths[1]))
    assert isinstance(tcfg, DecoderConfig)
    for f in tcfg.__dataclass_fields__:
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tp._data == jp._data
    assert paths[1].read_bytes() == paths[0].read_bytes()


def test_config_defaults_equal():
    assert config.DEMOD_DEFAULTS == jconfig.DEMOD_DEFAULTS
    assert config.DECODER_DEFAULTS == jconfig.DECODER_DEFAULTS


# -- Statistics_st ----------------------------------------------------------------

def test_statistics_pack_byte_equal():
    """Random batches and single frames (lost counters, failed RS blocks,
    dropped frames, both phases) through both packages' `Statistics`: the
    packed records are byte-equal after every update, and the independent
    header transcription of the interop tool reads them back."""
    rng = np.random.default_rng(21)
    a, b = Statistics(start_time=1000), JStatistics(start_time=1000)
    counters = {v: int(rng.integers(0, 100)) for v in range(1, 5)}
    for step in range(6):
        B = int(rng.integers(1, 40))
        vcid = rng.integers(1, 5, B)
        counter = np.zeros(B, np.int64)
        for k in range(B):
            counters[int(vcid[k])] += int(rng.integers(1, 4))
            counter[k] = counters[int(vcid[k])]
        kw = dict(
            scid=rng.integers(0, 64, B), vcid=vcid, counter=counter,
            vit_errors=rng.integers(0, 400, B), rs_errors=rng.integers(-1, 17, (B, 4)),
            sync_correlation=rng.integers(46, 65, B), phase_correction=rng.choice([0, 180], B),
            frame_ok=rng.random(B) > 0.2,
        )
        for s in (a, b):
            s.sync_word = bytes([0x1A, 0xCF, 0xFC, 0x1D])
            s.decoder_fifo_usage = step * 7
            if step % 2:
                for k in range(B):
                    s.update_frame(**{n: v[k] for n, v in kw.items()})
            else:
                s.update_batch(**kw)
        assert a.pack() == b.pack()
    d = interop_run.parse_stats(a.pack())
    assert d["total_packets"] == a.total_packets and d["dropped_packets"] == a.dropped_packets
    assert interop_run.STAT_SIZE == len(a.pack())


# -- the broadcast servers -----------------------------------------------------------

def test_broadcast_server_keeps_up_with_hrit():
    """2000 VCDU-sized payloads reach two clients whole and in order within
    a few seconds (the JAX package's server sends 20 payloads a second; HRIT
    makes ~57 frames a second), and `stop` sends what was queued before it,
    every time."""
    from xritdemod_tpu.runtime.dispatchers import BroadcastServer as JBroadcastServer

    from xritdemod_tpu_torch.runtime.dispatchers import BroadcastServer

    payloads = [bytes([i % 251]) * 892 for i in range(2000)]
    srv = BroadcastServer(0, host="127.0.0.1")
    cols = [interop_run.Collector(srv.bound_port, f"c{i}", connect_s=10) for i in range(2)]
    for c in cols:
        c.start()
        assert c.connected.wait(10)
    srv.start()
    try:
        deadline = time.monotonic() + 10
        while srv.num_clients() < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        t0 = time.monotonic()
        srv.add_many(payloads)
        while any(len(c.data) < 892 * len(payloads) for c in cols):
            assert time.monotonic() - t0 < 5.0, [len(c.data) for c in cols]
            time.sleep(0.01)
        srv.add(b"tail")
        srv.stop()
        deadline = time.monotonic() + 5
        while any(len(c.data) < 892 * len(payloads) + 4 for c in cols):
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        srv.stop()
        for c in cols:
            c.stop()
            c.join(5)
    for c in cols:
        assert c.data == b"".join(payloads) + b"tail"
    assert JBroadcastServer._loop is not BroadcastServer._loop


# -- the native library and the rings ---------------------------------------------

_LOADER = """
import sys
from xritdemod_tpu_torch.runtime import native
lib = native.load()
print("LOADED" if lib is not None else "NONE", native.library_path())
"""


@pytest.mark.skipif(not HAVE_GXX, reason="g++ is not installed")
def test_native_builds_once_under_concurrent_loads(tmp_path):
    """Four processes that start together on an empty build directory all
    load a whole library: the build runs under a file lock, to a private
    name, renamed into place; nothing is written under `native/`."""
    env = {**os.environ, "XRITDEMOD_TORCH_BUILD": str(tmp_path)}
    env.pop("PYTHONPATH", None)
    before = sorted(os.listdir(os.path.join(ROOT, "native")))
    procs = [
        subprocess.Popen([sys.executable, "-c", _LOADER], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for _ in range(4)
    ]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert all(o.startswith("LOADED " + str(tmp_path)) for o in outs), outs
    assert sorted(os.listdir(tmp_path)) == ["libxrit_io.lock", "libxrit_io.so"]
    assert sorted(os.listdir(os.path.join(ROOT, "native"))) == before


def test_native_build_failure_is_reported(tmp_path):
    """With the compiler missing the library is unavailable, and
    `last_error()` says why, naming the compiler; nothing is written but the
    lock."""
    env = {**os.environ, "XRITDEMOD_TORCH_BUILD": str(tmp_path),
           "CXX": str(tmp_path / "no-such-g++")}
    env.pop("PYTHONPATH", None)
    code = ("from xritdemod_tpu_torch.runtime import native\n"
            "print(native.last_error()); print(native.available()); print(native.last_error())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    before, avail, why = out.stdout.splitlines()
    assert before == "None" and avail == "False"
    assert "no-such-g++" in why and "not found" in why
    assert sorted(os.listdir(tmp_path)) == ["libxrit_io.lock"]


@pytest.fixture(scope="module")
def native_lib():
    if not HAVE_GXX:
        pytest.skip("g++ is not installed")
    assert native.available(), "g++ is present but the native library did not load"
    return native.load()


@pytest.mark.parametrize("blocking", [False, True])
def test_native_and_python_rings_agree(native_lib, blocking):
    """The same pushes and pops through `SampleFifo` on the C++ ring and on
    the Python ring: the same blocks, the same sizes, the same overflow
    count (drop-on-overflow) or no loss (blocking, with a consumer)."""
    rng = np.random.default_rng(3)
    chunks = [rng.normal(size=2 * int(rng.integers(1, 300))).astype(np.float32)
              for _ in range(60)]
    results = []
    for use_native in (True, False):
        fifo = SampleFifo(1024, blocking=blocking, use_native=use_native)
        assert (fifo._ring is not None) == use_native
        popped, sizes = [], []
        if blocking:
            total = sum(len(c) for c in chunks) // 2
            t = threading.Thread(target=lambda: [fifo.push(c) for c in chunks])
            t.start()
            while total >= 100:
                popped.append(fifo.pop_block(100, timeout=5.0))
                total -= 100
            t.join(10)
        else:
            for c in chunks:
                fifo.push(c)
                sizes.append(fifo.size())
                if fifo.size() >= 400:
                    popped.append(fifo.pop_block(150, timeout=1.0))
        fifo.close()
        results.append((popped, sizes, fifo.overflows))
    (np_, ns, no), (pp, ps, po) = results
    assert ns == ps and no == po
    assert len(np_) == len(pp) > 5
    for x, y in zip(np_, pp):
        np.testing.assert_array_equal(x, y)
    if blocking:
        assert no == 0


def test_native_quantizer_is_the_wire_rule(native_lib):
    soft = np.random.default_rng(4).normal(0, 0.8, 5000).astype(np.float32)
    soft[:6] = [0.5, -0.5, 2.0, -2.0, 0.0, 0.999]
    q = native.quantize_symbols_native(soft)
    np.testing.assert_array_equal(q, quantize_symbols(torch.from_numpy(soft)).numpy())
    np.testing.assert_array_equal(q[:6], [63, -63, 127, -128, 0, 126])


# -- checkpoints ------------------------------------------------------------------------

def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(tnp(a)), jax.tree.leaves(tnp(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_checkpoint_round_trip_resumes(tmp_path):
    """A serial state after one block saved and loaded is the same state, and
    the next block from it gives the same symbols; a fused receiver's state
    (ring, fill, lock, tails) round-trips too."""
    cfg = DemodConfig.lrit()
    demod = Demodulator(cfg, 2048, device="cpu")
    sig = (np.random.default_rng(6).normal(size=2048)
           + 1j * np.random.default_rng(7).normal(size=2048)).astype(np.complex64)
    _, _, st = demod.process(sig, demod.init_state())
    path = str(tmp_path / "s.npz")
    checkpoint.save_state(path, st)
    back = checkpoint.load_state(path, demod.init_state())
    _leaves_equal(st, back)
    s1, v1, _ = demod.process(sig, st)
    s2, v2, _ = demod.process(sig, back)
    assert torch.equal(s1, s2) and torch.equal(v1, v2)

    rx = FusedReceiver(cfg, DecoderConfig(), channels=2, block_len=2048, device="cpu")
    rst = rx.init_state()
    rst = rst._replace(fill=torch.tensor([5, 9], dtype=torch.int32),
                       locked=torch.tensor([True, False]),
                       ring=torch.randn(rst.ring.shape))
    checkpoint.save_state(path, rst)
    _leaves_equal(rst, checkpoint.load_state(path, rx.init_state()))
    with pytest.raises(ValueError):
        checkpoint.load_state(path, demod.init_state())


@pytest.mark.parametrize("batched", [False, True])
def test_checkpoints_cross_between_packages(tmp_path, batched):
    """A checkpoint the JAX package writes of a demod state (every leaf drawn
    at random, so that a leaf out of order shows) loads into the port's state
    of the same config as the state `convert.demod_state_from_numpy` gives;
    one the port writes loads back into the JAX package's state unchanged."""
    import jax.numpy as jnp

    jd = JDemodulator(JDemodConfig.lrit(), 2048)
    td = Demodulator(DemodConfig.lrit(), 2048, device="cpu")
    jlike, tlike = (jd.init_state_batch(2), td.init_state_batch(2)) if batched else (
        jd.init_state(), td.init_state())
    rng = np.random.default_rng(8)
    jst = jax.tree.map(
        lambda a: jnp.asarray(rng.integers(0, 1000, a.shape) if a.dtype.kind == "i"
                              else rng.normal(size=a.shape), a.dtype), jlike)
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_state(jpath, jst)
    got = checkpoint.load_state(jpath, tlike)
    _leaves_equal(got, convert.demod_state_from_numpy(jnp_tree(jst), "cpu"))

    tpath = str(tmp_path / "port.npz")
    checkpoint.save_state(tpath, got)
    back = jckpt.load_state(tpath, jlike)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jst)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_ring_checkpoint_crosses_between_packages(tmp_path):
    """A fused receiver's state with a bfloat16 ring: the JAX package's
    checkpoint loads into the port's bf16 ring bit for bit (and as
    `convert.rx_state_from_numpy` gives it); the port's loads back into the
    JAX package's state, the ring still bfloat16 and unchanged."""
    import jax.numpy as jnp
    from xritdemod_tpu.models.decoder import DecoderConfig as JDecoderConfig
    from xritdemod_tpu.models.receiver import FusedReceiver as JFusedReceiver

    jrx = JFusedReceiver(JDemodConfig.lrit(), JDecoderConfig(), channels=2, block_len=2048,
                         ring_dtype="bfloat16")
    trx = FusedReceiver(DemodConfig.lrit(), DecoderConfig(), channels=2, block_len=2048,
                        ring_dtype="bfloat16", device="cpu")
    jlike, tlike = jrx.init_state(), trx.init_state()
    assert tlike.ring.dtype == torch.bfloat16 and tlike.ring.shape == jlike.ring.shape
    rng = np.random.default_rng(12)
    jst = jlike._replace(ring=jnp.asarray(rng.normal(size=jlike.ring.shape), jnp.bfloat16),
                         fill=jnp.asarray([7, 300], jnp.int32))
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_state(jpath, jst)
    got = checkpoint.load_state(jpath, tlike)
    assert got.ring.dtype == torch.bfloat16
    want = convert.rx_state_from_numpy(jnp_tree(jst), "cpu")
    assert want.ring.dtype == torch.bfloat16
    assert torch.equal(got.ring.view(torch.int16), want.ring.view(torch.int16))
    np.testing.assert_array_equal(got.ring.float().numpy(), np.asarray(jst.ring, np.float32))
    assert tnp(got.ring).dtype.name == "bfloat16"
    checkpoint.save_state(tpath, got)
    back = jckpt.load_state(tpath, jlike)
    assert back.ring.dtype == jnp.bfloat16
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jst)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- metrics ------------------------------------------------------------------------------

def test_metrics_rates_and_trace(tmp_path):
    m = PipelineMetrics(window=60)
    for _ in range(5):
        m.add_samples(1000)
        m.add_frames(2)
        time.sleep(0.01)
    assert m.samples.total == 5000 and m.samples.rate() > 0
    assert "Msamp/s" in m.summary()
    log_dir = str(tmp_path / "trace")
    with trace(log_dir) as d:
        torch.ones(64).cumsum(0)
    assert d == log_dir and os.path.getsize(os.path.join(log_dir, TRACE_FILE)) > 0


# -- the command line ------------------------------------------------------------------

@pytest.mark.parametrize("argv, expect", [
    (["demod"], dict(cmd="demod", config="xritdemod.cfg", format="auto", device="cuda",
                     max_blocks=None, realtime=False)),
    (["demod", "--file", "a.u8", "--format", "u8", "--realtime", "--max-blocks", "3",
      "--device", "cpu"],
     dict(file="a.u8", format="u8", realtime=True, max_blocks=3, device="cpu")),
    (["decode", "--config", "d.cfg", "--display"],
     dict(cmd="decode", config="d.cfg", display=True, device="cuda")),
    (["rx", "--dump", "--file", "c.c64", "--device", "cpu"],
     dict(cmd="rx", dump=True, file="c.c64", config="xritdemod.cfg", device="cpu")),
    (["reprocess", "x.s8", "--format", "s8", "--folds", "64"],
     dict(cmd="reprocess", file="x.s8", format="s8", folds=64, block_len=1 << 17,
          out="channels", config="xritdemod.cfg", device="cuda")),
])
def test_cli_arguments(argv, expect):
    args = cli._parser().parse_args(argv)
    for k, v in expect.items():
        assert getattr(args, k) == v, k


@pytest.mark.parametrize("argv", [["reprocess"], ["demod", "--format", "c32"], []])
def test_cli_rejects(argv):
    with pytest.raises(SystemExit):
        cli._parser().parse_args(argv)


@pytest.mark.parametrize("name, fmt, kind", [
    ("cap.c64", "auto", "CFileFrontend"), ("cap.u8", "auto", "RtlFrontend"),
    ("cap.s8", "auto", "RtlFrontend"), ("cap.bin", "s8", "RtlFrontend"),
])
def test_cli_file_frontend_formats(tmp_path, name, fmt, kind):
    path = tmp_path / name
    path.write_bytes(b"\0" * 64)
    assert type(cli._file_frontend(str(path), fmt, False)).__name__ == kind


@pytest.mark.parametrize("cmd", ["demod", "decode", "rx"])
def test_cli_refuses_without_a_gpu(tmp_path, cmd):
    """Without a CUDA device and without `--device cpu` each command exits
    with an error before touching a config file or a port."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "xritdemod_tpu_torch.cli", cmd,
         "--config", str(tmp_path / "x.cfg")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
    assert not (tmp_path / "x.cfg").exists()


def test_interop_tool_parser_is_an_independent_transcription():
    """The interop tool's `Statistics_st` parser imports nothing of the
    runtime package: it is transcribed from the C header."""
    tree = ast.parse(open(interop_run.__file__).read())
    mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not any(m.startswith("xritdemod_tpu_torch.runtime") for m in mods)


@pytest.mark.parametrize("missing, raw_extra, n_failures", [
    ([], b"", 0),                      # every frame
    ([0, 1], b"", 0),                  # the cold-start head
    ([0, 9], b"", 0),                  # the head and a frame past the last whole block
    ([4], b"", 1),                     # a frame in the middle
    ([0, 1, 2, 9], b"", 1),            # more than HEAD
    ([], b"\x00" * 5, 1),              # a torn stream
])
def test_interop_frame_failures(missing, raw_extra, n_failures):
    """The frame rule the interop tool and chip_smoke's `rx` runs share:
    at most HEAD frames missing, each in the cold-start head or past the
    frames the whole blocks hold (`whole` = 9 of 10 here)."""
    rng = np.random.default_rng(3)
    vcdus = tx.make_vcdus(10, scid=13, vcid=5, rng=rng)
    want = {(5, i): bytes(v) for i, v in enumerate(vcdus)}
    raw = b"".join(bytes(v) for i, v in enumerate(vcdus) if i not in missing) + raw_extra
    check = interop_run.check_vcdus(raw, want)
    assert [k[1] for k in check["missing"]] == missing
    assert len(interop_run.frame_failures(check, 9)) == n_failures
