"""cofiles.stat / mcofiles.stat codecs (byte-compatible with the reference).

co_dstat_t   (reference global_basic.h:116-126):
    u32 shuf_id; bool koc; <3 pad> i32 kmerlen; i32 dim_rd_len;
    i32 comp_num; i32 infile_num; <4 pad> i64 all_ctx_ct        (32 bytes)
  followed by u32 ctx_ct[infile_num] and char[256][infile_num] names
  (reference command_dist.c:477-500).

mco_dstat_t  (reference command_dist.h:67-75):
    u32 shuf_id; i32 kmerlen; i32 dim_rd_len; i32 comp_num; i32 infile_num
  (20 bytes) followed by the same ctx_ct + names tail
  (reference command_dist.c:526-540).
"""

from __future__ import annotations

import dataclasses
import os
import struct
import numpy as np

PATHLEN = 256
CO_DSTAT = "cofiles.stat"
MCO_DSTAT = "mcofiles.stat"

_CO_HDR = struct.Struct("<IB3xiiiiq")
_MCO_HDR = struct.Struct("<Iiiii")


def _read_names(f, n: int) -> list[str]:
    raw = f.read(PATHLEN * n)
    return [raw[i * PATHLEN:(i + 1) * PATHLEN].split(b"\0", 1)[0].decode()
            for i in range(n)]


def _write_names(f, names: list[str]) -> None:
    for nm in names:
        b = nm.encode()[:PATHLEN - 1]
        f.write(b + b"\0" * (PATHLEN - len(b)))


@dataclasses.dataclass
class CoStat:
    shuf_id: int
    koc: bool
    kmerlen: int          # 2*k
    dim_rd_len: int       # 2*drlevel
    comp_num: int
    all_ctx_ct: int
    ctx_ct: np.ndarray    # uint32[infile_num]
    names: list[str]

    @property
    def infile_num(self) -> int:
        return len(self.names)

    @classmethod
    def read(cls, dirpath: str) -> "CoStat":
        with open(os.path.join(dirpath, CO_DSTAT), "rb") as f:
            (sid, koc, kmerlen, drl, comp, nfile,
             all_ct) = _CO_HDR.unpack(f.read(_CO_HDR.size))
            ctx_ct = np.fromfile(f, dtype=np.uint32, count=nfile)
            names = _read_names(f, nfile)
        return cls(sid, bool(koc), kmerlen, drl, comp, all_ct, ctx_ct, names)

    def write(self, dirpath: str) -> None:
        os.makedirs(dirpath, exist_ok=True)
        with open(os.path.join(dirpath, CO_DSTAT), "wb") as f:
            f.write(_CO_HDR.pack(self.shuf_id, int(self.koc), self.kmerlen,
                                 self.dim_rd_len, self.comp_num,
                                 self.infile_num, self.all_ctx_ct))
            self.ctx_ct.astype(np.uint32).tofile(f)
            _write_names(f, self.names)


@dataclasses.dataclass
class McoStat:
    shuf_id: int
    kmerlen: int
    dim_rd_len: int
    comp_num: int
    ctx_ct: np.ndarray
    names: list[str]

    @property
    def infile_num(self) -> int:
        return len(self.names)

    @classmethod
    def from_costat(cls, c: CoStat) -> "McoStat":
        return cls(c.shuf_id, c.kmerlen, c.dim_rd_len, c.comp_num,
                   c.ctx_ct, list(c.names))

    @classmethod
    def read(cls, dirpath: str) -> "McoStat":
        with open(os.path.join(dirpath, MCO_DSTAT), "rb") as f:
            sid, kmerlen, drl, comp, nfile = _MCO_HDR.unpack(f.read(_MCO_HDR.size))
            ctx_ct = np.fromfile(f, dtype=np.uint32, count=nfile)
            names = _read_names(f, nfile)
        return cls(sid, kmerlen, drl, comp, ctx_ct, names)

    def write(self, dirpath: str) -> None:
        os.makedirs(dirpath, exist_ok=True)
        with open(os.path.join(dirpath, MCO_DSTAT), "wb") as f:
            f.write(_MCO_HDR.pack(self.shuf_id, self.kmerlen, self.dim_rd_len,
                                  self.comp_num, self.infile_num))
            self.ctx_ct.astype(np.uint32).tofile(f)
            _write_names(f, self.names)
