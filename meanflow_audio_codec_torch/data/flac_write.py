"""A small FLAC encoder: test vectors for the loader's decoder and the
corpus writer of ``tools/make_corpus.py``.

Counterpart of ``meanflow_audio_codec_tpu/data/flac_write.py``: the same
bitstream, byte for byte, for the same arguments. It writes real FLAC (the
magic, STREAMINFO, frames with CRC-8 and CRC-16) with every subframe type
the decoder of ``native/dataloader.cpp`` reads: CONSTANT, VERBATIM,
FIXED(0-4) and LPC with the caller's coefficients, Rice partitions,
raw-bits escapes, wasted bits and the three stereo decorrelations.

The JAX package writes one field at a time in Python. Here each subframe is
a pair of numpy arrays, the field values and their widths in bits, packed
in one pass (``_pack``), and the Rice parameter of a partition is the
cheapest of the sixteen by the exact cost computed over the whole
partition at once; the choice and its ties are the JAX package's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


def _crc_table(poly: int, width: int) -> tuple[int, ...]:
    top, mask = 1 << (width - 1), (1 << width) - 1
    table = []
    for byte in range(256):
        c = byte << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) & mask if c & top else (c << 1) & mask
        table.append(c)
    return tuple(table)


_CRC8 = _crc_table(0x07, 8)
_CRC16 = _crc_table(0x8005, 16)


def _crc8(data: bytes) -> int:
    c = 0
    for byte in data:
        c = _CRC8[c ^ byte]
    return c


def _crc16(data: bytes) -> int:
    c = 0
    for byte in data:
        c = ((c << 8) & 0xFFFF) ^ _CRC16[(c >> 8) ^ byte]
    return c


class _Fields:
    """MSB-first fields: values with their widths in bits, packed at once.

    A value is taken modulo 2**width (two's complement for a negative one).
    A unary code of q is the value 1 in q + 1 bits.
    """

    def __init__(self) -> None:
        self._values: list[np.ndarray] = []
        self._widths: list[np.ndarray] = []

    def add(self, values, widths) -> None:
        values = np.atleast_1d(np.asarray(values, dtype=np.int64))
        widths = np.broadcast_to(np.asarray(widths, dtype=np.int64),
                                 values.shape)
        self._values.append(values.reshape(-1))
        self._widths.append(widths.reshape(-1))

    def add_unary(self, q) -> None:
        q = np.atleast_1d(np.asarray(q, dtype=np.int64))
        self.add(np.ones_like(q), q + 1)

    @property
    def bit_length(self) -> int:
        return int(sum(int(w.sum()) for w in self._widths))

    def align(self) -> None:
        if self.bit_length % 8:
            self.add(0, 8 - self.bit_length % 8)

    def getvalue(self) -> bytes:
        values = np.concatenate(self._values).view(np.uint64)
        widths = np.concatenate(self._widths)
        if int(widths.sum()) % 8:
            raise ValueError("unaligned")
        return _pack(values, widths)


def _pack(values: np.ndarray, widths: np.ndarray) -> bytes:
    """Pack ``values`` (uint64) MSB first into fields of ``widths`` bits."""
    keep = widths > 0
    values, widths = values[keep], widths[keep]
    mask = np.where(widths >= 64, _ALL_ONES,
                    (np.uint64(1) << np.minimum(widths, 63).astype(np.uint64))
                    - np.uint64(1))
    values = values & mask
    ends = np.cumsum(widths)
    bits = np.zeros(int(ends[-1]) if len(ends) else 0, dtype=np.uint8)
    top = int(values.max()).bit_length() if len(values) else 0
    for k in range(top):
        on = ((values >> np.uint64(k)) & np.uint64(1)).astype(bool)
        bits[ends[on] - 1 - k] = 1
    return np.packbits(bits).tobytes()


def _utf8_number(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    for nbytes, capacity in ((2, 11), (3, 16), (4, 21), (5, 26), (6, 31),
                             (7, 36)):
        if n < (1 << capacity):
            lead_bits = capacity - 6 * (nbytes - 1)
            out = [((0xFF << (8 - nbytes)) & 0xFF)
                   | ((n >> (6 * (nbytes - 1))) & ((1 << lead_bits) - 1))]
            for i in range(nbytes - 2, -1, -1):
                out.append(0x80 | ((n >> (6 * i)) & 0x3F))
            return bytes(out)
    raise ValueError(f"number too large for FLAC utf8 coding: {n}")


def _write_residual(fields: _Fields, residual: np.ndarray, pred_order: int,
                    blocksize: int, partition_order: int = 0,
                    escape: bool = False) -> None:
    """Rice-coded (method 0) residual section; ``escape`` writes the
    raw-bits escape code in every partition instead."""
    fields.add([0, partition_order], [2, 4])  # method 0: 4-bit parameters
    partitions = 1 << partition_order
    if blocksize % partitions:
        raise ValueError(f"blocksize {blocksize} is not a multiple of "
                         f"{partitions} partitions")
    psize = blocksize // partitions
    pos = 0
    for p in range(partitions):
        count = psize - (pred_order if p == 0 else 0)
        part = residual[pos:pos + count].astype(np.int64)
        pos += count
        if escape:
            raw_bits = 1
            if count:
                raw_bits = max(1, int(np.max(np.abs(part))).bit_length() + 1)
            fields.add([0xF, raw_bits], [4, 5])
            fields.add(part, raw_bits)
            continue
        mapped = np.where(part >= 0, part << 1, ((-part) << 1) - 1)
        # the exact cost of each parameter; argmin keeps the first of ties
        costs = [int((mapped >> param).sum()) + (1 + param) * count
                 for param in range(15)]
        param = int(np.argmin(costs))
        fields.add(param, 4)
        pairs = np.stack([np.ones_like(mapped), mapped], axis=1)
        widths = np.stack([(mapped >> param) + 1,
                           np.full_like(mapped, param)], axis=1)
        fields.add(pairs, widths)


def _write_subframe(fields: _Fields, samples: np.ndarray, bps: int,
                    mode: str, partition_order: int = 0,
                    lpc: tuple[list[int], int, int] | None = None,
                    wasted: int = 0, escape: bool = False) -> None:
    s = samples.astype(np.int64)
    if wasted:
        if np.any(s & ((1 << wasted) - 1)):
            raise ValueError("wasted-bits samples must be multiples of "
                             "2**wasted")
        s = s >> wasted
    ebps = bps - wasted
    blocksize = len(s)

    def header(type_bits: int) -> None:
        fields.add([0, type_bits], [1, 6])  # pad, type
        if wasted:
            fields.add(1, 1)
            fields.add_unary(wasted - 1)
        else:
            fields.add(0, 1)

    if mode == "constant":
        if not np.all(s == s[0]):
            raise ValueError("a constant subframe needs equal samples")
        header(0b000000)
        fields.add(s[0], ebps)
    elif mode == "verbatim":
        header(0b000001)
        fields.add(s, ebps)
    elif mode.startswith("fixed"):
        order = int(mode[-1])
        header(0b001000 | order)
        fields.add(s[:order], ebps)
        res = np.diff(s, n=order) if order else s.copy()
        _write_residual(fields, res, order, blocksize, partition_order,
                        escape)
    elif mode == "lpc":
        coefs, shift, precision = lpc
        order = len(coefs)
        header(0b100000 | (order - 1))
        fields.add(s[:order], ebps)
        fields.add([precision - 1, shift], [4, 5])
        fields.add(np.asarray(coefs, dtype=np.int64), precision)
        acc = np.zeros(blocksize - order, dtype=np.int64)
        for j in range(order):
            acc += int(coefs[j]) * s[order - 1 - j:blocksize - 1 - j]
        _write_residual(fields, s[order:] - (acc >> shift), order, blocksize,
                        partition_order, escape)
    else:
        raise ValueError(f"unknown subframe mode {mode!r}")


_SS_CODE = {8: 0b001, 12: 0b010, 16: 0b100, 20: 0b101, 24: 0b110}
_STEREO_ASGN = {"left_side": 8, "right_side": 9, "mid_side": 10}


def write_flac(path, audio: np.ndarray, sample_rate: int = 44100,
               bits: int = 16, blocksize: int | None = None,
               mode: str = "verbatim", stereo: str = "independent",
               partition_order: int = 0,
               lpc: tuple[list[int], int, int] | None = None,
               wasted: int = 0, escape: bool = False,
               corrupt_crc16: bool = False) -> None:
    """Write integer samples ``audio[C, T]`` as a FLAC file.

    ``mode`` selects the subframe type for every channel: ``constant`` /
    ``verbatim`` / ``fixed0..fixed4`` / ``lpc`` (with ``lpc=(coefs, shift,
    precision)``). ``stereo`` selects channel decorrelation for C == 2.
    ``corrupt_crc16`` flips a bit in the first frame's CRC, so a test can
    check that the decoder rejects a damaged frame.
    """
    audio = np.atleast_2d(np.asarray(audio, dtype=np.int64))
    channels, total = audio.shape
    if blocksize is None:
        blocksize = total
    if not 1 <= channels <= 8:
        raise ValueError(f"FLAC takes 1 to 8 channels, got {channels}")
    lim = 1 << (bits - 1)
    if np.any(audio < -lim) or np.any(audio >= lim):
        raise ValueError(f"samples outside the {bits}-bit range")

    out = bytearray(b"fLaC")
    # STREAMINFO (type 0, last metadata block, 34 bytes)
    si = _Fields()
    last_bs = total % blocksize or blocksize
    si.add([min(blocksize, last_bs), blocksize, 0, 0, sample_rate,
            channels - 1, bits - 1, total >> 32, total & 0xFFFFFFFF, 0, 0, 0,
            0], [16, 16, 24, 24, 20, 3, 5, 4, 32, 32, 32, 32, 32])
    out += bytes([0x80, 0, 0, 34]) + si.getvalue()

    asgn = (_STEREO_ASGN.get(stereo, channels - 1) if channels == 2
            else channels - 1)
    if channels != 2 and stereo != "independent":
        raise ValueError(f"stereo={stereo!r} needs two channels")

    for frame_index, start in enumerate(range(0, total, blocksize)):
        block = audio[:, start:start + blocksize]
        bs = block.shape[1]
        head = _Fields()
        # sync, reserved, fixed blocking, blocksize from the header's end,
        # sample rate from STREAMINFO, channel assignment, sample size,
        # reserved
        head.add([0x3FFE, 0, 0, 0b0111, 0b0000, asgn, _SS_CODE[bits], 0],
                 [14, 1, 1, 4, 4, 4, 3, 1])
        head.add(np.frombuffer(_utf8_number(frame_index), dtype=np.uint8), 8)
        head.add(bs - 1, 16)
        header = head.getvalue()

        if asgn == 8:  # left/side
            subs = [(block[0], bits), (block[0] - block[1], bits + 1)]
        elif asgn == 9:  # right/side
            subs = [(block[0] - block[1], bits + 1), (block[1], bits)]
        elif asgn == 10:  # mid/side
            side = block[0] - block[1]
            mid = (block[0] + block[1]) >> 1
            subs = [(mid, bits), (side, bits + 1)]
        else:
            subs = [(block[c], bits) for c in range(channels)]
        body = _Fields()
        for sub, sub_bits in subs:
            _write_subframe(body, sub, sub_bits, mode, partition_order, lpc,
                            wasted, escape)
        body.align()
        frame = header + bytes([_crc8(header)]) + body.getvalue()
        crc = _crc16(frame)
        if corrupt_crc16 and frame_index == 0:
            crc ^= 1
        out += frame + bytes([crc >> 8, crc & 0xFF])

    with open(path, "wb") as f:
        f.write(out)


def write_flac_pcm16(path, audio: np.ndarray,
                     sample_rate: int = 44100) -> None:
    """Write (T,) or (T, C) float32 [-1, 1] audio as 16-bit FLAC.

    The contract of ``data.audio.write_wav``, with compressing defaults:
    fixed-order-2 prediction, mid/side stereo for C == 2, 4096-sample
    blocks.
    """
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[:, None]
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int64).T  # (C, T)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    stereo = "mid_side" if pcm.shape[0] == 2 else "independent"
    write_flac(path, pcm, sample_rate=sample_rate, bits=16,
               blocksize=min(4096, pcm.shape[1]), mode="fixed2",
               stereo=stereo)
