"""Host-side sequence ingestion: fasta/fastq(.gz) -> 2-bit code streams.

The device kernels consume a flat ``uint8`` code array in which
  0..3   = A/C/G/T (case-insensitive; reference Basemap, global_basic.c:62-70)
  >= 4   = window reset (N, any non-ACGT character, record boundary,
           quality-filtered base)
Newlines inside a fasta record do NOT reset (reference iseq2comem.c:257:
'\\n'/'\\r' are skipped), so sequence lines are concatenated directly.

A C++ parser (native/fastseq.cpp) accelerates this path when built; the
NumPy implementation below is the portable fallback and the semantic
reference.
"""

from __future__ import annotations

import gzip
import io
import os
import numpy as np

RESET = np.uint8(255)

# char -> 2-bit code, everything else RESET
BASEMAP = np.full(256, RESET, dtype=np.uint8)
for i, chars in enumerate(("Aa", "Cc", "Gg", "Tt")):
    for ch in chars:
        BASEMAP[ord(ch)] = i

FASTA_EXTS = (".fasta", ".fna", ".fas", ".fa")
FASTQ_EXTS = (".fq", ".fastq")


def open_maybe_gz(path: str) -> io.BufferedReader:
    f = open(path, "rb")
    if f.peek(2)[:2] == b"\x1f\x8b":
        return gzip.open(f)  # type: ignore[return-value]
    return f


def sniff_format(path: str) -> str:
    base = path[:-3] if path.endswith(".gz") else path
    ext = os.path.splitext(base)[1].lower()
    if ext in FASTA_EXTS:
        return "fasta"
    if ext in FASTQ_EXTS:
        return "fastq"
    # content sniff
    with open_maybe_gz(path) as f:
        first = f.read(1)
    return "fastq" if first == b"@" else "fasta"


def fasta_to_codes(path: str, return_headers: bool = False):
    """Whole-file code stream; '>'-headers become single RESET markers.

    With ``return_headers``, also return the positions of the header
    markers in the code stream (sequence r spans
    ``(headers[r], headers[r+1])``) — used by per-read sketching.
    """
    from metakssd_tpu_torch.io import native
    nat = native.parse_fasta(path) if native.available() else None
    if nat is not None:
        codes, headers = nat
        return (codes, headers) if return_headers else codes
    with open_maybe_gz(path) as f:
        data = f.read()
    pos = 0
    n = len(data)
    out = np.empty(n, dtype=np.uint8)
    out_n = 0
    headers: list[int] = []
    while pos < n:
        eol = data.find(b"\n", pos)
        if eol == -1:
            eol = n
        line = data[pos:eol]
        pos = eol + 1
        if line.endswith(b"\r"):
            line = line[:-1]
        if not line:
            continue
        if line[0:1] == b">":
            headers.append(out_n)
            out[out_n] = RESET
            out_n += 1
            continue
        arr = BASEMAP[np.frombuffer(line, dtype=np.uint8)]
        out[out_n:out_n + arr.size] = arr
        out_n += arr.size
    if return_headers:
        return out[:out_n], np.asarray(headers, dtype=np.int64)
    return out[:out_n]


def fastq_to_codes(path: str, min_qual: int = 0,
                   max_read_len: int | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Return (codes, read_index) for a fastq file.

    codes: one entry per base plus one RESET separator between reads.
    read_index: int64[nreads+1] offsets of each read's first base in codes
    (used by per-read sketching).  Bases with quality byte < min_qual are
    RESET in place (reference iseq2comem.c:365 compares the raw
    phred+33 byte to Q).
    """
    if max_read_len is None:
        from metakssd_tpu_torch.io import native
        nat = native.parse_fastq(path, min_qual) if native.available() \
            else None
        if nat is not None:
            return nat
    seqs: list[bytes] = []
    quals: list[bytes] = []
    with open_maybe_gz(path) as f:
        while True:
            h = f.readline()
            if not h:
                break
            s = f.readline().rstrip(b"\r\n")
            f.readline()
            q = f.readline().rstrip(b"\r\n")
            if max_read_len is not None:
                s = s[:max_read_len]
                q = q[:max_read_len]
            seqs.append(s)
            quals.append(q)
    nreads = len(seqs)
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=nreads)
    read_index = np.zeros(nreads + 1, dtype=np.int64)
    np.cumsum(lens + 1, out=read_index[1:])   # +1 for separators
    total = int(read_index[-1])
    codes = np.full(total, RESET, dtype=np.uint8)
    for i, s in enumerate(seqs):
        start = int(read_index[i])
        arr = BASEMAP[np.frombuffer(s, dtype=np.uint8)]
        if min_qual > 0:
            q = np.frombuffer(quals[i], dtype=np.uint8)
            if q.size == arr.size:
                arr = np.where(q < min_qual, RESET, arr)
        codes[start:start + arr.size] = arr
    # read_index points at read starts; strip the trailing separator pos
    starts = read_index.copy()
    return codes, starts


def pipecmd_to_codes(pipecmd: str, path: str, min_qual: int = 0
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Run '<pipecmd> <path>' and parse its stdout as fastq (the
    reference assumes pipecmd emits fastq, iseq2comem.c:377).  Returns
    (codes, read_starts)."""
    import subprocess
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".fq") as tf:
        subprocess.run(f"{pipecmd} {path}", shell=True, check=True,
                       stdout=tf)
        tf.flush()
        return fastq_to_codes(tf.name, min_qual=min_qual)
