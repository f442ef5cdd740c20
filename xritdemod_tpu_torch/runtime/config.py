"""key=value config files, wire-compatible with the reference's ConfigParser.

The port's own loader, over the port's `DemodConfig` and `DecoderConfig`:
the JAX package's `runtime/config.py` with its imports pointed at the port
(the same keys, preset override, extension keys and written default files;
`tests/test_torch_config.py` holds the two loaders equal).

The reference parses `xritdemod.cfg` / `xritdecoder.cfg` with SatHelper's
ConfigParser and auto-writes defaults when missing
(demodulator/src/demodulator.cpp:237-243,
 decoder/src/newdecoder.cpp:99-104, 28-36).  Key names are
preserved verbatim (Parameters.h:60-79; decoder parameters.h:47-54) so
existing config files drop in.
"""

from __future__ import annotations

import os

from xritdemod_tpu_torch import constants as C
from xritdemod_tpu_torch.models.decoder import DecoderConfig
from xritdemod_tpu_torch.models.demodulator import DemodConfig

__all__ = [
    "ConfigParser",
    "demod_config_from_file",
    "decoder_config_from_file",
    "DEMOD_DEFAULTS",
    "DECODER_DEFAULTS",
]


class ConfigParser:
    """SatHelper::ConfigParser semantics: `key=value` lines, `#` comments."""

    def __init__(self, filename: str):
        self.filename = filename
        self._data: dict[str, str] = {}

    def load_file(self) -> bool:
        if not os.path.exists(self.filename):
            return False
        with open(self.filename) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                k, _, v = line.partition("=")
                self._data[k.strip()] = v.strip()
        return True

    def save_file(self) -> None:
        with open(self.filename, "w") as f:
            for k, v in self._data.items():
                f.write(f"{k}={v}\n")

    def has_key(self, key: str) -> bool:
        return key in self._data

    def get(self, key: str, default: str | None = None) -> str:
        if default is not None and key not in self._data:
            return default
        return self._data[key]

    def get_int(self, key: str) -> int:
        return int(self._data[key])

    def get_float(self, key: str) -> float:
        return float(self._data[key])

    def get_bool(self, key: str) -> bool:
        return self._data[key].strip().lower() in ("true", "1", "yes")

    def __getitem__(self, key: str) -> str:
        return self._data[key]

    def __setitem__(self, key: str, value) -> None:
        self._data[key] = str(value)


# Defaults mirror setDefaults (demodulator.cpp:177-211), which calls
# setLRITMode(normal=true) first — so the written file also carries
# symbolRate/rrcAlpha/frequency like the reference's.
DEMOD_DEFAULTS = {
    "symbolRate": str(C.LRIT_SYMBOL_RATE),
    "rrcAlpha": str(C.LRIT_RRC_ALPHA),
    "frequency": str(C.LRIT_CENTER_FREQUENCY),
    "mode": "lrit",
    "deviceType": "cfile",
    "filename": "",
    "sampleRate": str(C.DEFAULT_SAMPLE_RATE),
    "decimation": str(C.DEFAULT_DECIMATION),
    "agcEnabled": "true",
    "lnaGain": str(C.DEFAULT_LNA_GAIN),
    "vgaGain": str(C.DEFAULT_VGA_GAIN),
    "mixerGain": str(C.DEFAULT_MIX_GAIN),
    "decoderAddress": C.DEFAULT_DECODER_ADDRESS,
    "decoderPort": str(C.DEFAULT_DECODER_PORT),
    "deviceNumber": str(C.DEFAULT_DEVICE_NUMBER),
    "sendConstellation": "true",
    "biast": str(C.DEFAULT_BIAST),
    "spyserverHost": "127.0.0.1",
    "spyserverPort": "5555",
}

# Defaults mirror decoder setDefaults (newdecoder.cpp:28-36).
DECODER_DEFAULTS = {
    "mode": "lrit",
    "display": "false",
    "demodulatorPort": str(C.DEFAULT_DEMODULATOR_PORT),
    "vChannelPort": str(C.DEFAULT_VCHANNEL_PORT),
    "statisticsPort": str(C.DEFAULT_STATISTICS_PORT),
}


def _load_with_defaults(filename: str, defaults: dict) -> ConfigParser:
    p = ConfigParser(filename)
    if not p.load_file():
        for k, v in defaults.items():
            p[k] = v
        p.save_file()
    return p


def demod_config_from_file(
    filename: str = "xritdemod.cfg",
) -> tuple[DemodConfig, ConfigParser]:
    """Load demod config with mode presets (demodulator.cpp:245-341)."""
    p = _load_with_defaults(filename, DEMOD_DEFAULTS)
    # When `mode` is present the preset OVERRIDES the file's symbolRate/
    # rrcAlpha — the reference prints "Ignoring parameters from config
    # file" and overwrites them via setLRITMode/setHRITMode(parser, false)
    # before reading (demodulator.cpp:245-256, 177-197).  The file's
    # explicit values only apply when no mode key exists.
    mode = p.get("mode", "lrit") if p.has_key("mode") else ""
    if mode == "hrit":
        symbol_rate, rrc_alpha = C.HRIT_SYMBOL_RATE, C.HRIT_RRC_ALPHA
    elif mode == "lrit":
        symbol_rate, rrc_alpha = C.LRIT_SYMBOL_RATE, C.LRIT_RRC_ALPHA
    elif mode:
        # Reference exits with "Invalid mode specified"
        # (demodulator.cpp:252-255); don't run at a silently wrong rate.
        raise ValueError(f"invalid mode in {filename!r}: {mode!r}")
    else:
        symbol_rate, rrc_alpha = C.LRIT_SYMBOL_RATE, C.LRIT_RRC_ALPHA
        if p.has_key("symbolRate"):
            symbol_rate = p.get_int("symbolRate")
        if p.has_key("rrcAlpha"):
            rrc_alpha = p.get_float("rrcAlpha")
    sample_rate = (
        p.get_int("sampleRate") if p.has_key("sampleRate") else C.DEFAULT_SAMPLE_RATE
    )
    decimation = (
        p.get_int("decimation") if p.has_key("decimation") else C.DEFAULT_DECIMATION
    )
    # pllAlpha default is CLOCK_ALPHA, with a warning when overridden
    # (demodulator.cpp:262-265).
    pll_alpha = C.CLOCK_ALPHA
    if p.has_key("pllAlpha"):
        pll_alpha = p.get_float("pllAlpha")
    # Extension key (no reference counterpart): the M&M fractional
    # interpolator family — "mmse" (default; the GR-parity table, the
    # golden model's interpolator) or "sinc" (exact-mu windowed sinc).
    clock_interp = p.get("clockInterp", "mmse") if p.has_key(
        "clockInterp"
    ) else "mmse"
    cfg = DemodConfig(
        symbol_rate=symbol_rate,
        sample_rate=sample_rate,
        decimation=decimation,
        rrc_alpha=rrc_alpha,
        pll_alpha=pll_alpha,
        clock_interp=clock_interp,
    )
    return cfg, p


def decoder_config_from_file(
    filename: str = "xritdecoder.cfg",
) -> tuple[DecoderConfig, ConfigParser]:
    p = _load_with_defaults(filename, DECODER_DEFAULTS)
    mode = p.get("mode", "lrit") if p.has_key("mode") else "lrit"
    kw = {}
    if p.has_key("framesPerBlock"):
        # Device batch size of the streaming decoder: larger batches
        # amortize the fixed per-dispatch link latency (throughput) at
        # the cost of one batch of output latency.
        kw["frames_per_block"] = p.get_int("framesPerBlock")
    return DecoderConfig(mode=mode, **kw), p
