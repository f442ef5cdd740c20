"""K5 / K6: the port's standalone AGC and Costas stages against the JAX
package's Pallas kernels (`ops/stream_pallas.py`) in interpret mode.

On the CPU the port's wrappers (`ops/stream_cuda.py`) take their plain
versions, whose arithmetic the CUDA kernels repeat step for step
(`csrc/loops.cuh`).  Shapes are the smallest the Pallas kernels take:
C = 128 channels (one lane tile), T = 1024 (rows=256).  Tolerances: AGC is
the same float32 operations in order (1e-6); the Costas loop calls sin/cos
of two different libraries (1e-5 on output and phase, 1e-6 on freq).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import tnp
from xritdemod_tpu.ops import agc as jagc
from xritdemod_tpu.ops import costas as jcostas
from xritdemod_tpu.ops.stream_pallas import agc_block_pallas, costas_block_pallas
from xritdemod_tpu.utils.cplx import CF32 as JCF
from xritdemod_tpu_torch.ops import agc as tagc
from xritdemod_tpu_torch.ops import costas as tcostas
from xritdemod_tpu_torch.ops import clock_cuda, frontend_cuda, stream_cuda
from xritdemod_tpu_torch.utils.cplx import CF32 as TCF

C, T = 128, 1024


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _signal(rng, scale=0.3, t=T):
    n = np.arange(t)
    re = 0.5 * np.cos(0.004 * n + 0.3)[None, :] + rng.normal(0, scale, (C, t))
    im = 0.5 * np.sin(0.004 * n + 0.3)[None, :] + rng.normal(0, scale, (C, t))
    return re.astype(np.float32), im.astype(np.float32)


@pytest.mark.parametrize("scale,g0", [(0.3, 1.0), (1e-5, 3996.0)])
def test_agc_matches_pallas_interpret(rng, scale, g0):
    """Also where the max-gain clamp binds mid-block (tiny input, gain
    started just under the clamp)."""
    re, im = _signal(rng, scale)
    if scale < 1e-3:
        re, im = re * 1e-5, im * 1e-5
    gain = rng.uniform(0.9, 1.0, C).astype(np.float32) * np.float32(g0)
    jy, jg = agc_block_pallas(
        JCF(jnp.asarray(re), jnp.asarray(im)), jnp.asarray(gain), jagc.AgcParams(),
        rows=256, interpret=True,
    )
    ty, tg = stream_cuda.agc_block_kernel(TCF(_t(re), _t(im)), _t(gain), tagc.AgcParams())
    assert ty.re.shape == (C, T) and tg.shape == (C,)
    # rtol on top of atol: at a gain of 4000 one float32 ulp is 2.4e-4.
    np.testing.assert_allclose(ty.re.numpy(), np.asarray(jy.re), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(ty.im.numpy(), np.asarray(jy.im), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=1e-6)
    if scale < 1e-3:
        assert float(tg.max()) == 4000.0


def test_costas_matches_pallas_interpret(rng):
    re, im = _signal(rng, 0.05)
    ph0 = rng.uniform(-1, 1, C).astype(np.float32)
    fr0 = rng.uniform(-0.01, 0.01, C).astype(np.float32)
    gains = jcostas.costas_gains(0.0037)
    assert tuple(gains) == tuple(tcostas.costas_gains(0.0037))
    jy, js = costas_block_pallas(
        JCF(jnp.asarray(re), jnp.asarray(im)),
        jcostas.CostasState(jnp.asarray(ph0), jnp.asarray(fr0)), gains,
        rows=256, interpret=True,
    )
    ty, ts = stream_cuda.costas_block_kernel(
        TCF(_t(re), _t(im)), tcostas.CostasState(_t(ph0), _t(fr0)),
        tcostas.costas_gains(0.0037),
    )
    np.testing.assert_allclose(ty.re.numpy(), np.asarray(jy.re), atol=1e-5)
    np.testing.assert_allclose(ty.im.numpy(), np.asarray(jy.im), atol=1e-5)
    np.testing.assert_allclose(ts.phase.numpy(), np.asarray(js.phase), atol=1e-5)
    np.testing.assert_allclose(ts.freq.numpy(), np.asarray(js.freq), atol=1e-6)


def test_costas_wraps_and_clamps_like_pallas(rng):
    """A locked loop on a carrier of 0.5 rad/sample: the phase passes 2pi
    every dozen samples (single wrap step), and freq_max set to the carrier's
    own rate makes the freq clamp bind about half the time; same tolerances."""
    n = np.arange(T)
    re = (0.9 * np.cos(0.5 * n + 0.2))[None, :] + rng.normal(0, 0.02, (C, T))
    im = (0.9 * np.sin(0.5 * n + 0.2))[None, :] + rng.normal(0, 0.02, (C, T))
    re, im = re.astype(np.float32), im.astype(np.float32)
    ph0 = np.full(C, 0.2, np.float32)
    fr0 = np.full(C, 0.5, np.float32)
    jgains = jcostas.costas_gains(0.0037)._replace(freq_max=0.5)
    tgains = tcostas.costas_gains(0.0037)._replace(freq_max=0.5)
    jy, js = costas_block_pallas(
        JCF(jnp.asarray(re), jnp.asarray(im)),
        jcostas.CostasState(jnp.asarray(ph0), jnp.asarray(fr0)), jgains,
        rows=256, interpret=True,
    )
    ty, ts = stream_cuda.costas_block_kernel(
        TCF(_t(re), _t(im)), tcostas.CostasState(_t(ph0), _t(fr0)), tgains,
    )
    np.testing.assert_allclose(ty.re.numpy(), np.asarray(jy.re), atol=1e-5)
    np.testing.assert_allclose(ty.im.numpy(), np.asarray(jy.im), atol=1e-5)
    np.testing.assert_allclose(ts.phase.numpy(), np.asarray(js.phase), atol=1e-5)
    np.testing.assert_allclose(ts.freq.numpy(), np.asarray(js.freq), atol=1e-6)
    assert float(ts.freq.max()) == 0.5 and float(ts.freq.min()) < 0.5
    assert float(ty.re.abs().mean()) > 0.8          # locked: energy on the real axis


@pytest.mark.parametrize("stage", ["agc", "costas"])
def test_two_chained_blocks_equal_one_double_block(rng, stage):
    """Exactly: the carried state is all that crosses a block boundary."""
    re, im = _signal(rng, 0.05, 2 * T)
    full = TCF(_t(re), _t(im))
    a, b = TCF(_t(re[:, :T]), _t(im[:, :T])), TCF(_t(re[:, T:]), _t(im[:, T:]))
    if stage == "agc":
        p = tagc.AgcParams()
        run = lambda x, st: stream_cuda.agc_block_kernel(x, st, p)
        st0 = tagc.agc_init(p, (C,))
    else:
        p = tcostas.costas_gains(0.0037)
        run = lambda x, st: stream_cuda.costas_block_kernel(x, st, p)
        st0 = tcostas.costas_init((C,))
    yf, sf = run(full, st0)
    ya, sa = run(a, st0)
    yb, sb = run(b, sa)
    np.testing.assert_array_equal(yf.re[:, :T].numpy(), ya.re.numpy())
    np.testing.assert_array_equal(yf.re[:, T:].numpy(), yb.re.numpy())
    np.testing.assert_array_equal(yf.im[:, T:].numpy(), yb.im.numpy())
    for x, y in zip(jax.tree.leaves(tnp(sf)), jax.tree.leaves(tnp(sb))):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("stage", ["agc", "costas"])
def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch(rng, stage):
    re, im = _signal(rng, 0.05, 64)
    x = TCF(_t(re[:3]), _t(im[:3]))
    before = (stream_cuda.launches_agc, stream_cuda.launches_costas)
    if stage == "agc":
        p = tagc.AgcParams()
        got = stream_cuda.agc_block_kernel(x, tagc.agc_init(p, (3,)), p)
        want = tagc.agc_block(x, tagc.agc_init(p, (3,)), p)
    else:
        p = tcostas.costas_gains(0.0037)
        got = stream_cuda.costas_block_kernel(x, tcostas.costas_init((3,)), p)
        want = tcostas.costas_block(x, tcostas.costas_init((3,)), p)
    np.testing.assert_array_equal(got[0].re.numpy(), want[0].re.numpy())
    np.testing.assert_array_equal(got[0].im.numpy(), want[0].im.numpy())
    assert (stream_cuda.launches_agc, stream_cuda.launches_costas) == before


# The warp-specialised kernels' warps by index, and the recursion that sets
# each one's time.  K1's AGC gain chain is a recursion too, but it waits on
# the Costas chain most of the time and shares scheduler 2 with two FIR warps.
WARP_LAYOUTS = {
    "frontend": (frontend_cuda.ROLES, "costas"),
    "frontend_slab_exact_costas": (frontend_cuda.roles(8, "agc"), "costas"),
    "frontend_slab_exact_costas_tr64": (frontend_cuda.roles(64, "agc"), "costas"),
    "clock": (clock_cuda.ROLES["clock"], "chain"),
    "agc_block": (stream_cuda.ROLES["agc_block"], "agc"),
    "costas_block": (stream_cuda.ROLES["costas_block"], "costas"),
}


@pytest.mark.parametrize("kernel", sorted(WARP_LAYOUTS))
def test_chain_warp_has_its_scheduler_to_itself(kernel):
    """A warp's scheduler is its index mod 4, and a scheduler issues
    greedily: a busy warp beside a chain warp slows the chain.  So no other
    busy role (None is a warp that leaves at once) shares the chain's."""
    roles, chain = WARP_LAYOUTS[kernel]
    assert roles.count(chain) == 1 and len(roles) <= 32
    w = roles.index(chain)
    beside = [r for i, r in enumerate(roles) if i != w and i % 4 == w % 4 and r is not None]
    assert beside == []
    assert "loader" in roles and "store" in roles


@pytest.mark.parametrize("kernel", ["clock_sinc", "clock_bu_sinc"])
def test_sinc_chain_warps_have_a_scheduler_each(kernel):
    """K2's sinc instances (`clock_sinc_kernel` of csrc/clock.cu) serve
    SINC_CPB channels a block with SINC_LPC lanes a channel: SINC_CPB *
    SINC_LPC / 32 chain warps, then the loader and the store warp, as
    `ROLES` names them.  No two chain warps share a scheduler (warp index
    mod 4), and beside a chain warp sits at most one other warp, the loader
    or the store warp, which mostly wait on their barriers."""
    src = (Path(clock_cuda.__file__).parents[1] / "csrc" / "clock.cu").read_text()
    lpc = int(re.search(r"#define SINC_LPC (\d+)", src).group(1))
    cpb = int(re.search(r"#define SINC_CPB (\d+)", src).group(1))
    chains = cpb * lpc // 32
    roles = clock_cuda.ROLES[kernel]
    assert roles == ("chain",) * chains + ("loader", "store")
    assert "constexpr int SINC_WARPS = SINC_CHAINS + 2;" in src
    for w in range(chains):
        beside = [r for i, r in enumerate(roles) if i != w and i % 4 == w % 4]
        assert len(beside) <= 1 and "chain" not in beside


def test_bu_chain_warps_have_a_scheduler_each():
    """K2's mmse block update (`clock_bu_kernel` of csrc/clock.cu) serves
    BU_CPB channels a block with BU_LPC lanes a channel: BU_CPB * BU_LPC /
    32 chain warps, then the loader, as `ROLES` names them (the chain lanes
    store their own symbols: no store warp).  No two chain warps share a
    scheduler, and beside a chain warp sits at most the loader."""
    src = (Path(clock_cuda.__file__).parents[1] / "csrc" / "clock.cu").read_text()
    lpc = int(re.search(r"#define BU_LPC (\d+)", src).group(1))
    cpb = int(re.search(r"#define BU_CPB (\d+)", src).group(1))
    chains = cpb * lpc // 32
    roles = clock_cuda.ROLES["clock_bu"]
    assert roles == ("chain",) * chains + ("loader",)
    assert "constexpr int BU_CPW = 32 / BU_LPC;" in src
    assert "constexpr int BU_CHAINS = BU_CPB / BU_CPW;" in src
    assert "constexpr int BU_WARPS = BU_CHAINS + 1;" in src
    for w in range(chains):
        beside = [r for i, r in enumerate(roles) if i != w and i % 4 == w % 4]
        assert beside in ([], ["loader"])


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_slab_chain_warps_have_a_scheduler_each(lanes):
    """K6's spread slab walk (`costas_spread_kernel` of csrc/stream.cu)
    serves CPB channels a block with SLAB_LPC lanes a channel: its chain
    warps, at warps 3, 1, 4, 6 (`SpreadLayout`), sit one to a scheduler,
    beside at most the loader or the store warp; `ROLES["costas_slab"]` is
    the shipped SLAB_LPC's layout.  K1's slab kernel spreads the walk over
    32 / SCPB lanes a channel in one warp, its Costas warp 3."""
    src = (Path(stream_cuda.__file__).parents[1] / "csrc" / "stream.cu").read_text()
    lpc = int(re.search(r"#define SLAB_LPC (\d+)", src).group(1))
    cpb = int(re.search(r"#define CPB (\d+)", src).group(1))
    assert stream_cuda.ROLES["costas_slab"] == stream_cuda.spread_roles(lpc)
    assert lpc == stream_cuda.SLAB_LANES
    assert "return w == 3 ? 0 : CHAINS > 1 && w == 1 ? 1 : CHAINS > 2 && w == 4 ? 2" in src
    roles = stream_cuda.spread_roles(lanes)
    chains = [w for w, r in enumerate(roles) if r == "costas"]
    assert len(chains) == max(1, cpb * lanes // 32)
    for w in chains:
        beside = [r for i, r in enumerate(roles) if i != w and i % 4 == w % 4 and r]
        assert len(beside) <= 1 and "costas" not in beside
    fsrc = (Path(stream_cuda.__file__).parents[1] / "csrc" / "frontend.cu").read_text()
    scpb = int(re.search(r"#define SCPB (\d+)", fsrc).group(1))
    assert scpb == 16 and "kernel<<<(a.C + SCPB - 1) / SCPB," in fsrc
    assert "constexpr int L = 32 / SCPB, N = SK / L;" in fsrc
    # K1's slab walk: one Costas warp (warp 3); beside it, on scheduler 3, the
    # gain chain (SLAB_AGC_WARP) and SLAB_MAG_WARPS - 1 of the magnitude
    # warps (`SlabLayout`), as `roles` names them.
    mags = int(re.search(r"#define SLAB_MAG_WARPS (\d+)", fsrc).group(1))
    assert "#define SLAB_AGC_WARP IDLE7 " in fsrc
    r = frontend_cuda.roles(8)
    assert r.count("costas") == 1 and r[3] == "costas" and r[7] == "agc"
    assert r.count("mag") == mags and r[11] == "mag" and r.count("agc") == 1


def test_stream_roles_match_the_kernel_source():
    """`ROLES` names the warps `csrc/stream.cu` launches: loader, magnitude,
    store, chain by `enum Role`, then the AGC's further magnitude warps."""
    src = (Path(stream_cuda.__file__).parents[1] / "csrc" / "stream.cu").read_text()
    assert "enum Role { LOADER, MAG, STORE, CHAIN_WARP };" in src
    mags = int(re.search(r"#define MAG_WARPS (\d+)", src).group(1))
    agc, costas = stream_cuda.ROLES["agc_block"], stream_cuda.ROLES["costas_block"]
    assert agc[:4] == ("loader", "mag", "store", "agc") and agc.count("mag") == mags
    assert len(agc) == (4 if mags == 1 else 3 + mags)
    assert costas == ("loader", None, "store", "costas")
