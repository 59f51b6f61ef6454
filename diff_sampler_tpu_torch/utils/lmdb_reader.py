"""Minimal pure-Python read-only LMDB reader.

Counterpart of ``diff_sampler_tpu/utils/lmdb_reader.py``.  The reference's
dataset_tool ingests LSUN LMDB databases through the `lmdb` C binding
(`amed-solver-main/dataset_tool.py:113-139`), which neither machine the
port runs on has.  LSUN ingestion only needs a forward cursor
over (key, value) pairs of the main database, so this module implements just
that against the on-disk format of liblmdb (mdb.c):

  * meta pages 0/1 (MDB_meta after the 16-byte page header; the live meta is
    the one with the larger txnid and valid magic 0xBEEFC0DE),
  * page header: pgno u64 | pad u16 | flags u16 | lower u16 | upper u16,
    flags: BRANCH=0x01 LEAF=0x02 OVERFLOW=0x04 META=0x08 LEAF2=0x20,
  * node: lo u16 | hi u16 | flags u16 | ksize u16 | key | data; branch nodes
    encode the child pgno in lo|hi<<16|flags<<32; leaf data size is
    lo|hi<<16; leaf flag F_BIGDATA=0x01 means the data is a u64 pgno of an
    OVERFLOW page run holding the value bytes.

Limitations (fine for LSUN-style image stores): no DUPSORT sub-databases,
no LEAF2 fixed-size-key pages, no named sub-databases, read-only.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Tuple

__all__ = ["LMDBReader"]

MAGIC = 0xBEEFC0DE
P_BRANCH, P_LEAF, P_OVERFLOW, P_META, P_LEAF2 = 0x01, 0x02, 0x04, 0x08, 0x20
F_BIGDATA, F_SUBDATA, F_DUPDATA = 0x01, 0x02, 0x04
PAGEHDRSZ = 16
INVALID_PGNO = 0xFFFFFFFFFFFFFFFF


class _Meta:
    __slots__ = ("psize", "txnid", "main_root", "main_entries", "main_depth",
                 "main_flags", "last_pg")


def _parse_meta(buf: bytes) -> _Meta:
    # MDB_meta starts after the page header.
    off = PAGEHDRSZ
    magic, version = struct.unpack_from("<II", buf, off)
    if magic != MAGIC:
        raise ValueError(f"not an LMDB meta page (magic {magic:#x})")
    if version not in (1, 999):  # MDB_DATA_VERSION; 999 = devel
        raise ValueError(f"unsupported LMDB data version {version}")
    m = _Meta()
    # address(8) + mapsize(8) follow; then mm_dbs[2] of 48 bytes each.
    dbs = off + 24
    m.psize = struct.unpack_from("<I", buf, dbs)[0]  # FREE_DBI md_pad
    main = dbs + 48
    (_pad, m.main_flags, m.main_depth) = struct.unpack_from("<IHH", buf, main)
    (_branch, _leaf, _ovf, m.main_entries, m.main_root) = struct.unpack_from(
        "<QQQQQ", buf, main + 8)
    m.last_pg, m.txnid = struct.unpack_from("<QQ", buf, main + 48)
    return m


class LMDBReader:
    """Forward-iterate (key, value) pairs of an LMDB main database.

    Accepts the database directory (containing data.mdb) or the file itself.
    """

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._f = open(path, "rb")
        self._size = os.fstat(self._f.fileno()).st_size
        head = self._read_raw(0, 8192 * 2)
        # psize is recorded in the meta itself; meta 0 starts at offset 0.
        m0 = _parse_meta(head)
        m1 = _parse_meta(head[m0.psize:]) if self._size >= 2 * m0.psize else m0
        self.meta = m0 if m0.txnid >= m1.txnid else m1
        self.psize = self.meta.psize

    # -- low-level ----------------------------------------------------------
    def _read_raw(self, off: int, n: int) -> bytes:
        self._f.seek(off)
        return self._f.read(n)

    def _page(self, pgno: int, npages: int = 1) -> bytes:
        return self._read_raw(pgno * self.psize, npages * self.psize)

    @staticmethod
    def _page_header(page: bytes) -> Tuple[int, int, int, int]:
        pgno, _pad, flags, lower, upper = struct.unpack_from("<QHHHH", page, 0)
        return pgno, flags, lower, upper

    def _iter_page(self, pgno: int) -> Iterator[Tuple[bytes, bytes]]:
        page = self._page(pgno)
        _pg, flags, lower, upper = self._page_header(page)
        if flags & P_LEAF2:
            raise NotImplementedError("LEAF2 (fixed-key) pages unsupported")
        nkeys = (lower - PAGEHDRSZ) >> 1
        offsets = struct.unpack_from(f"<{nkeys}H", page, PAGEHDRSZ)
        if flags & P_BRANCH:
            for o in offsets:
                lo, hi, nflags = struct.unpack_from("<HHH", page, o)
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._iter_page(child)
            return
        if not flags & P_LEAF:
            raise ValueError(f"unexpected page flags {flags:#x} at pgno {pgno}")
        for o in offsets:
            lo, hi, nflags, ksize = struct.unpack_from("<HHHH", page, o)
            key = page[o + 8 : o + 8 + ksize]
            dsize = lo | (hi << 16)
            if nflags & (F_SUBDATA | F_DUPDATA):
                raise NotImplementedError("DUPSORT databases unsupported")
            if nflags & F_BIGDATA:
                (ovf_pgno,) = struct.unpack_from("<Q", page, o + 8 + ksize)
                ovf = self._page(ovf_pgno)
                _p, oflags, _lo, _up = self._page_header(ovf)
                assert oflags & P_OVERFLOW, f"pgno {ovf_pgno} not overflow"
                (npages,) = struct.unpack_from("<I", ovf, 12)
                raw = self._page(ovf_pgno, npages)
                value = raw[PAGEHDRSZ : PAGEHDRSZ + dsize]
            else:
                value = page[o + 8 + ksize : o + 8 + ksize + dsize]
            yield key, value

    # -- public --------------------------------------------------------------
    def __len__(self) -> int:
        return self.meta.main_entries

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        root = self.meta.main_root
        if root == INVALID_PGNO:
            return
        yield from self._iter_page(root)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
