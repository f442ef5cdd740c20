"""Tuning constants and frame geometry for the GOES xRIT receive chain.

The port's own copy of the reference operating points (the JAX package keeps
its own in `xritdemod_tpu/constants.py`; the two must stay equal, which
`tests/test_torch_imports.py` pins).  Sources in opensatelliteproject/xritdemod:
  - demodulator constants: demodulator/src/Parameters.h:14-57
  - decoder frame geometry: decoder/src/parameters.h:27-44
  - coded-domain sync words: decoder/src/newdecoder.cpp:21-24
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# GOES downlink operating points (Parameters.h:16-24)
# ---------------------------------------------------------------------------
HRIT_CENTER_FREQUENCY = 1_694_100_000
HRIT_SYMBOL_RATE = 927_000
HRIT_RRC_ALPHA = 0.3

LRIT_CENTER_FREQUENCY = 1_691_000_000
LRIT_SYMBOL_RATE = 293_883
LRIT_RRC_ALPHA = 0.5

# ---------------------------------------------------------------------------
# Loop settings (Parameters.h:26-37).  Note the reference's shipped default
# Costas bandwidth is CLOCK_ALPHA (demodulator.cpp:220), not PLL_ALPHA.
# ---------------------------------------------------------------------------
LOOP_ORDER = 2
RRC_TAPS = 63
PLL_ALPHA = 0.001
CLOCK_ALPHA = 0.0037
CLOCK_MU = 0.5
CLOCK_OMEGA_LIMIT = 0.005
CLOCK_GAIN_OMEGA = (CLOCK_ALPHA * CLOCK_ALPHA) / 4.0
AGC_RATE = 0.01
AGC_REFERENCE = 0.5
AGC_GAIN = 1.0
AGC_MAX_GAIN = 4000.0

AIRSPY_MINI_DEFAULT_SAMPLERATE = 3_000_000
AIRSPY_R2_DEFAULT_SAMPLERATE = 2_500_000
DEFAULT_SAMPLE_RATE = AIRSPY_MINI_DEFAULT_SAMPLERATE
DEFAULT_DECIMATION = 1
DEFAULT_DEVICE_NUMBER = 0

DEFAULT_DECODER_ADDRESS = "127.0.0.1"
DEFAULT_DECODER_PORT = 5000

DEFAULT_LNA_GAIN = 5
DEFAULT_VGA_GAIN = 5
DEFAULT_MIX_GAIN = 5
DEFAULT_BIAST = 0

# Host-side ingest FIFO, in float samples (Parameters.h:54-57)
FIFO_SIZE = 1024 * 1024

# ---------------------------------------------------------------------------
# CADU frame geometry (decoder parameters.h:27-44)
# ---------------------------------------------------------------------------
FRAME_SIZE = 1024                      # bytes per decoded CADU frame
FRAME_BITS = FRAME_SIZE * 8            # 8192
CODED_FRAME_SIZE = FRAME_BITS * 2      # 16384 soft bytes per coded frame
MIN_CORRELATION_BITS = 46
RS_BLOCKS = 4
RS_PARITY_SIZE = 32
RS_PARITY_BLOCK = RS_PARITY_SIZE * RS_BLOCKS   # 128
SYNC_WORD_SIZE = 32                    # bits
SYNC_WORD_BYTES = SYNC_WORD_SIZE // 8  # 4
LAST_FRAME_DATA_BITS = 64              # soft bytes of history prepended to Viterbi
LAST_FRAME_DATA = LAST_FRAME_DATA_BITS // 8    # 8
TIMEOUT = 2                            # seconds

DEFAULT_FLYWHEEL_RECHECK = 4
DEFAULT_DEMODULATOR_PORT = 5000
DEFAULT_VCHANNEL_PORT = 5001
DEFAULT_STATISTICS_PORT = 5002

# VCDU payload = frame minus RS parity minus sync marker (newdecoder.cpp:357-359)
VCDU_SIZE = FRAME_SIZE - RS_PARITY_BLOCK - SYNC_WORD_BYTES   # 892

# ---------------------------------------------------------------------------
# Coded-domain 64-bit unique words (newdecoder.cpp:21-24).
# UW0 is the 0-degree pattern; UW2 the 180-degree (BPSK ambiguity) pattern.
# For LRIT, UW2 == ~UW0 exactly; for HRIT the NRZ-M precoding makes the
# transient bits differ.
# ---------------------------------------------------------------------------
HRIT_UW0 = 0xFC4EF4FD0CC2DF89
HRIT_UW2 = 0x25010B02F33D2076
LRIT_UW0 = 0xFCA2B63DB00D9794
LRIT_UW2 = 0x035D49C24FF2686B

# CCSDS attached sync marker (decoded domain)
SYNC_MARKER = 0x1ACFFC1D

# ---------------------------------------------------------------------------
# Convolutional code (CCSDS rate-1/2, K=7).  Polynomials in Phil-Karn bit
# order as used by libcorrect / SatHelper's Viterbi27 (survey §2c).
# Convention locked numerically against the published UWs
# (tests/test_decode_ops.py::TestConvCode): with sr = (sr << 1) | bit,
#   c1 = parity(sr & 0x4F) ^ 1,  c2 = parity(sr & 0x6D) ^ 1,
# zero initial state, MSB-first bits, conv_encode(0x1ACFFC1D) == LRIT_UW0
# exactly (and HRIT_UW0 with NRZ-M precoding, previous encoded bit 0).
# Coded bit 1 maps to a negative BPSK soft symbol.
# ---------------------------------------------------------------------------
CONV_K = 7
CONV_POLY_A = 0x4F   # first transmitted coded bit of each pair (inverted)
CONV_POLY_B = 0x6D   # second coded bit of each pair (inverted)

# Reed-Solomon (255,223) CCSDS dual-basis parameters
RS_N = 255
RS_K = 223
RS_T = 16
RS_GF_POLY = 0x187   # x^8 + x^7 + x^2 + x + 1
RS_FCR = 112         # first consecutive root
RS_PRIM = 11         # primitive element alpha^11 generates the code roots

# Symbol transport quantization (SymbolManager.cpp:43-46): float * 127,
# clamped to int8 [-128, 127].
SYMBOL_SCALE = 127.0
