"""The ranked text of ``composite -s <mode>`` (``name\\t%f\\n`` a line):
what both card routes (``ops/dense_abv``, ``ops/abv_postings``) do after
their device search.  ``StagedNames.stage``, once per staged index, holds
the names for the host writer and, on a card, there (``CardText``);
``rank_order`` ranks a query's samples by the tie-break its route passes;
``StagedNames.write`` writes a query's lines, on the card where it can,
and says whether it did; ``HEADERS`` names each mode's column.

``CardText.stage(names, device)`` puts the sample names on the device once
(a uint8 blob and int64 offsets [N + 1]) with reusable buffers sized for
a text of every sample: the lines' input (float64 values, int32 sample
ids), a scratch of int64 lengths and the text, each with a pinned host
twin on a card.  ``CardText.text(ids, vals)`` then makes a query's text
in one upload of its ranked (sample id, value) pairs, ``format_lines``,
one readback of the text's length and flagged count and one of exactly
the text's bytes, decoded once.  It returns None where a line cannot be
printed exactly by this route (a value that is not finite or above 9e12
in magnitude): the caller then writes the whole text with the host
writer.

``format_lines`` is, on a card, the hand-written kernel
``mkssd_abv_format_lines`` (``csrc/abv.cu``; its calls counted in
``_build.LAUNCHES["abv_format_lines"]``), and for tensors on the CPU its
plain twin ``format_lines_plain``.  Both print a value as glibc's ``%f``
does, by the host writer's arithmetic (``native/fastseq.cpp``
``fast_f6``): for v = m * 2^e, d = round_half_even(m * 5^6 * 2^(e + 6))
exactly, a '-' whenever the sign bit is set (-0.0 included), d // 10^6,
'.', and the six digits of d % 10^6.
"""

from __future__ import annotations

import dataclasses
import struct
import threading

import numpy as np
import torch

from metakssd_tpu_torch.io import native as native_io
from metakssd_tpu_torch.ops import _build

HEADERS = {0: "CosineXY", 1: "L1norm", 2: "L2norm"}
BLOCK_LINES = 256        # lines a block of the kernel (kFmtThreads)
LINE_EXTRA = 30          # bytes a line beyond its name: '\t', at most
                         # 21 of value (sign, 13 digits, '.', 6), '\n'
MAX_D = 9 * 10 ** 18     # the largest round(|v| * 10^6) printed here


def f6_plain(v: float) -> bytes | None:
    """``"%f" % v`` as bytes by the kernel's integer arithmetic, or None
    where the kernel flags the value (not finite, or d above MAX_D).
    Python's integers are exact, so the kernel's shortcuts (d = 0 below
    2^-120 of a unit in the last place, a flag above 2^50 of a shift) give
    the same digits."""
    bits = struct.unpack("<Q", struct.pack("<d", v))[0]
    biased, mant = (bits >> 52) & 0x7FF, bits & ((1 << 52) - 1)
    if biased == 0x7FF:
        return None
    m = mant if biased == 0 else mant | 1 << 52
    sh = (-1074 if biased == 0 else biased - 1075) + 6
    p = m * 15625
    if sh >= 0:
        d = p << sh
    else:
        i, frac, half = p >> -sh, p & ((1 << -sh) - 1), 1 << (-sh - 1)
        d = i + (frac > half or (frac == half and i & 1))
    if d > MAX_D:
        return None
    return b"%s%d.%06d" % (b"-" if bits >> 63 else b"", d // 10 ** 6,
                           d % 10 ** 6)


def format_lines_plain(blob, off, ids, vals, scratch, out) -> None:
    """``mkssd_abv_format_lines`` in plain Python over CPU tensors: the
    text of lines (ids[i], vals[i]) into ``out``, its length into
    ``scratch[0]`` and the lines it could not print (a flagged value, or
    a sample outside the names) into ``scratch[1]``."""
    names, o = blob.numpy().tobytes(), off.tolist()
    parts, flagged = [], 0
    for s, v in zip(ids.tolist(), vals.tolist()):
        value = f6_plain(v) if 0 <= s < len(o) - 1 else None
        if value is None:
            flagged += 1
            continue
        parts.append(b"%s\t%s\n" % (names[o[s]:o[s + 1]], value))
    text = b"".join(parts)
    scratch[0], scratch[1] = len(text), flagged
    if text and len(text) <= out.numel():
        out[:len(text)] = torch.frombuffer(bytearray(text), dtype=torch.uint8)


def format_lines(blob: torch.Tensor, off: torch.Tensor, ids: torch.Tensor,
                 vals: torch.Tensor, scratch: torch.Tensor,
                 out: torch.Tensor) -> None:
    """The text of the lines (ids[i], vals[i]) into ``out`` (uint8), its
    length into ``scratch[0]`` and the count of lines not printed into
    ``scratch[1]`` (the text is then incomplete); ``out`` holds nothing
    of use where ``scratch[0]`` exceeds its size.  blob: uint8 names end
    to end, name s at [off[s], off[s + 1]) (off int64 [N + 1]); ids int32,
    vals float64; scratch int64 of at least 2 + ceil(n / BLOCK_LINES).
    ``mkssd_abv_format_lines`` on a card, ``format_lines_plain`` on the
    CPU.  Nothing is synchronised."""
    dev = blob.device
    n = ids.numel()
    for name, t, dtype in (("blob", blob, torch.uint8),
                           ("off", off, torch.int64),
                           ("ids", ids, torch.int32),
                           ("vals", vals, torch.float64),
                           ("scratch", scratch, torch.int64),
                           ("out", out, torch.uint8)):
        _build.check_1d(name, t, dtype, dev)
    if vals.numel() != n or off.numel() < 1 or \
            scratch.numel() < 2 + -(-n // BLOCK_LINES):
        raise ValueError("format_lines: ids and vals differ in length, or "
                         "off or scratch is too short")
    if dev.type == "cpu":
        format_lines_plain(blob, off, ids, vals, scratch, out)
        return
    if dev.type != "cuda":
        raise ValueError(f"no text kernel for device {dev}")
    lib = _build.library()
    with _build.card_of(blob):
        err = lib.mkssd_abv_format_lines(
            blob.data_ptr(), off.data_ptr(), off.numel() - 1, ids.data_ptr(),
            vals.data_ptr(), n, scratch.data_ptr(), out.data_ptr(),
            out.numel(), torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(err, "mkssd_abv_format_lines")
    _build.LAUNCHES["abv_format_lines"] += 1


@dataclasses.dataclass
class CardText:
    """Sample names and text buffers on one device (see the module
    docstring)."""
    blob: torch.Tensor        # uint8: the names end to end
    off: torch.Tensor         # int64 [N + 1]
    lines: torch.Tensor       # uint8 [12 N]: float64 values, int32 ids
    lines_host: torch.Tensor  # pinned, as large
    lines_view: np.ndarray    # of lines_host
    scratch: torch.Tensor     # int64: text length, flagged, block lengths
    out: torch.Tensor         # uint8: the text
    out_host: torch.Tensor    # pinned, as large
    out_view: memoryview      # of out_host
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)

    @classmethod
    def stage(cls, names: list[str], device) -> "CardText":
        """``names`` on ``device`` with buffers for a text of every one of
        them (len(blob) + LINE_EXTRA bytes a name)."""
        dev = torch.device(device)
        pin = dev.type == "cuda"
        blob, off = native_io.encode_names(names)
        n = len(names)
        cap = len(blob) + LINE_EXTRA * n
        lines_host = torch.empty(12 * n, dtype=torch.uint8, pin_memory=pin)
        out_host = torch.empty(cap, dtype=torch.uint8, pin_memory=pin)
        return cls(
            torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(dev)
            if blob else torch.zeros(0, dtype=torch.uint8, device=dev),
            torch.from_numpy(off).to(dev),
            torch.empty(12 * n, dtype=torch.uint8, device=dev),
            lines_host, lines_host.numpy(),
            torch.empty(2 + -(-n // BLOCK_LINES), dtype=torch.int64,
                        device=dev),
            torch.empty(cap, dtype=torch.uint8, device=dev), out_host,
            memoryview(out_host.numpy()))

    def text(self, ids: np.ndarray, vals: np.ndarray) -> str | None:
        """The lines ``name\\t%f\\n`` of samples ``ids`` (distinct) with
        ``vals`` (float64), or None where ``format_lines`` flagged one.
        One text at a time: the buffers are shared by every caller of the
        staged index."""
        n = ids.size
        if 12 * n > self.lines.numel():
            raise ValueError(f"{n} lines for a text of at most "
                             f"{self.lines.numel() // 12} samples")
        if n == 0:
            return ""
        with self.lock:
            self.lines_view[:8 * n].view(np.float64)[:] = vals
            self.lines_view[8 * n:12 * n].view(np.int32)[:] = ids
            self.lines[:12 * n].copy_(self.lines_host[:12 * n])
            format_lines(self.blob, self.off,
                         self.lines[8 * n:12 * n].view(torch.int32),
                         self.lines[:8 * n].view(torch.float64),
                         self.scratch, self.out)
            total, flagged = self.scratch[:2].tolist()
            if flagged:
                return None
            if total > self.out.numel():
                raise RuntimeError(f"a text of {total} bytes for a buffer "
                                   f"of {self.out.numel()}")
            self.out_host[:total].copy_(self.out[:total])
            return str(self.out_view[:total], "utf-8")


def rank_order(measure: np.ndarray, tiebreak: np.ndarray) -> np.ndarray:
    """The order of a stable ascending sort on ``measure`` (float32; NaN
    last, -0.0 equal to 0.0, as NumPy sorts) of samples taken in
    ascending ``tiebreak`` order (distinct, in [0, 2^32)): one argsort of
    uint64 keys, the measure's bits made monotonic above the tie-break."""
    m = np.where(np.isnan(measure), np.float32(np.nan),
                 measure + np.float32(0.0))
    bits = m.view(np.uint32)
    bits = np.where(bits >= np.uint32(1 << 31), ~bits,
                    bits | np.uint32(1 << 31))
    return np.argsort((bits.astype(np.uint64) << np.uint64(32))
                      | tiebreak.astype(np.uint64))


@dataclasses.dataclass
class StagedNames:
    """The sample names of one staged index, as each writer of its text
    reads them (see the module docstring)."""
    names: list[str]
    blob: bytes | None          # io/native.names_blob; None without the
    off: np.ndarray | None      # host library (numpy's %f then)
    card: CardText | None = None

    @classmethod
    def stage(cls, names: list[str], device) -> "StagedNames":
        """``names`` for the host writer and, where ``device`` is a card,
        on it (``CardText.stage``)."""
        dev = torch.device(device)
        return cls(names, *native_io.names_blob(names),
                   CardText.stage(names, dev) if dev.type == "cuda" else None)

    def write(self, out, ids: np.ndarray, vals: np.ndarray) -> bool:
        """Write the lines ``name\\t%f\\n`` of samples ``ids`` with their
        printed values ``vals`` (float64) to ``out``; True where the card
        formatted them, False where the host writer did (on the CPU, or
        a value the card's route flags)."""
        text = self.card.text(ids, vals) if self.card is not None else None
        if text is not None:
            out.write(text)
            return True
        native_io.write_name_float_lines(out, self.names, self.blob,
                                         self.off, ids, vals)
        return False
