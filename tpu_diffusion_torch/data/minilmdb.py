"""Pure-Python reader (+ minimal writer) for the LMDB on-disk format.

The port's own copy of `tpu_diffusion/data/minilmdb.py` (standard library
only).

The reference's `LMDBDataset` (`amortised diffusion/src/utils/
lmdb_dataset.py:38-625`) requires the `lmdb` C module, which this image
does not ship. This module implements the standard LMDB data format
(lmdb.tech mdb.c layout, 64-bit, little-endian) directly:

  * `MiniLMDB`: read-only access — parses the dual meta pages (picks the
    newer committed txn), walks the main DB's B+tree (branch/leaf pages),
    and resolves big values through overflow pages;
  * `write_minilmdb`: a small writer emitting the same format (meta pages
    0/1 + sorted leaf pages + one optional branch level + overflow pages)
    so fixtures can be built and round-tripped without the C library.

Scope (enough for the reference's usage — keyed blob storage): no dupsort,
no named sub-databases, no free-list tracking, read-only single-snapshot
access. A cross-validation test against the real `lmdb` module runs
automatically wherever that module is installed
(tests/test_lmdb.py::test_cross_validate_with_real_lmdb, over the JAX
package's copy; tests/test_torch_storage.py holds the two copies equal).

Format constants follow lmdb's mdb.c: MDB_MAGIC 0xBEEFC0DE, data version
1; page header {pgno u64, pad u16, flags u16, lower u16, upper u16};
flags: BRANCH=0x01 LEAF=0x02 OVERFLOW=0x04 META=0x08; leaf node
{lo u16, hi u16, flags u16, ksize u16, key, data} with datasize =
lo | hi<<16 and F_BIGDATA=0x01 meaning data = u64 overflow pgno; branch
node child pgno = lo | hi<<16 | flags<<32.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08

F_BIGDATA = 0x01

PAGEHDRSZ = 16

# MDB_db: pad u32, flags u16, depth u16, branch_pages u64, leaf_pages u64,
# overflow_pages u64, entries u64, root u64  -> 48 bytes
_DB_FMT = "<IHHQQQQQ"
_DB_SIZE = struct.calcsize(_DB_FMT)
# MDB_meta: magic u32, version u32, address u64, mapsize u64,
#           dbs[2] (2 * 48), last_pg u64, txnid u64
_META_FMT = "<IIQQ" + "96s" + "QQ"

_INVALID_PGNO = 0xFFFFFFFFFFFFFFFF


class MiniLMDBError(Exception):
    pass


class MiniLMDB:
    """Read-only LMDB data-file parser.

    `path` may be the environment directory (containing data.mdb, as
    `lmdb.open(subdir=True)` creates) or the data file itself.
    """

    def __init__(self, path: str, page_size: Optional[int] = None):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        with open(path, "rb") as f:
            self._data = f.read()
        # The on-disk page size lives in meta page 0 (always at byte 0):
        # mm_psize is the FREE db's pad field (mdb.c `#define mm_psize
        # mm_dbs[FREE_DBI].md_pad`). Hardcoding 4096 would misparse files
        # written by the real library on 16K/64K-page hosts.
        self.page_size = page_size or self._detect_page_size()
        meta = self._pick_meta()
        (self.main_depth, self.main_entries,
         self.main_root) = meta

    # -- meta ------------------------------------------------------------

    def _parse_meta_at(self, offset: int):
        data = self._data
        if offset + PAGEHDRSZ + struct.calcsize(_META_FMT) > len(data):
            raise MiniLMDBError("meta offset past end of file")
        _, _, flags, _, _ = struct.unpack_from("<QHHHH", data, offset)
        if not flags & P_META:
            raise MiniLMDBError(f"offset {offset} is not a meta page")
        magic, version, _, _, dbs, _, txnid = struct.unpack_from(
            _META_FMT, data, offset + PAGEHDRSZ)
        if magic != MDB_MAGIC:
            raise MiniLMDBError(f"bad magic {magic:#x}")
        if version != MDB_DATA_VERSION:
            raise MiniLMDBError(f"unsupported data version {version}")
        psize = struct.unpack_from(_DB_FMT, dbs, 0)[0]  # dbs[0] = FREE
        main = struct.unpack_from(_DB_FMT, dbs, _DB_SIZE)  # dbs[1] = MAIN
        _, _, depth, _, _, _, entries, root = main
        return txnid, psize, (depth, entries, root)

    def _detect_page_size(self) -> int:
        try:
            _, psize, _ = self._parse_meta_at(0)
            if psize >= 512 and psize & (psize - 1) == 0:
                return psize
        except (MiniLMDBError, struct.error):
            pass
        # meta 0 unreadable/legacy (psize 0): find meta 1 by scanning the
        # plausible page sizes for a valid meta page at that offset
        for cand in (4096, 8192, 16384, 32768, 65536, 512, 1024, 2048):
            try:
                self._parse_meta_at(cand)
                return cand
            except (MiniLMDBError, struct.error):
                continue
        return 4096

    def _parse_meta(self, pgno: int):
        txnid, _, main = self._parse_meta_at(pgno * self.page_size)
        return txnid, main

    def _pick_meta(self):
        cands = []
        for pgno in (0, 1):
            try:
                cands.append(self._parse_meta(pgno))
            except (MiniLMDBError, struct.error):
                pass
        if not cands:
            raise MiniLMDBError("no valid meta page (not an LMDB file?)")
        return max(cands)[1]  # newer txnid wins

    # -- pages -----------------------------------------------------------

    def _page(self, pgno: int) -> memoryview:
        start = pgno * self.page_size
        if start >= len(self._data):
            raise MiniLMDBError(f"page {pgno} out of range")
        return memoryview(self._data)[start:]

    def _page_nodes(self, page: memoryview) -> List[int]:
        _, _, _, lower, _ = struct.unpack_from("<QHHHH", page, 0)
        n = (lower - PAGEHDRSZ) // 2
        return list(struct.unpack_from(f"<{n}H", page, PAGEHDRSZ))

    def _leaf_node(self, page: memoryview, off: int) -> Tuple[bytes, bytes]:
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", page, off)
        key = bytes(page[off + 8:off + 8 + ksize])
        datasize = lo | (hi << 16)
        if flags & F_BIGDATA:
            (ov_pgno,) = struct.unpack_from("<Q", page, off + 8 + ksize)
            return key, self._overflow(ov_pgno, datasize)
        start = off + 8 + ksize
        return key, bytes(page[start:start + datasize])

    def _branch_child(self, page: memoryview, off: int) -> int:
        lo, hi, flags, _ = struct.unpack_from("<HHHH", page, off)
        return lo | (hi << 16) | (flags << 32)

    def _overflow(self, pgno: int, size: int) -> bytes:
        page = self._page(pgno)
        _, _, flags, _, _ = struct.unpack_from("<QHHHH", page, 0)
        if not flags & P_OVERFLOW:
            raise MiniLMDBError(f"page {pgno} is not an overflow page")
        return bytes(page[PAGEHDRSZ:PAGEHDRSZ + size])

    # -- traversal -------------------------------------------------------

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        if self.main_root == _INVALID_PGNO:
            return
        yield from self._walk(self.main_root)

    def _walk(self, pgno: int) -> Iterator[Tuple[bytes, bytes]]:
        page = self._page(pgno)
        _, _, flags, _, _ = struct.unpack_from("<QHHHH", page, 0)
        offs = self._page_nodes(page)
        if flags & P_LEAF:
            for off in offs:
                yield self._leaf_node(page, off)
        elif flags & P_BRANCH:
            for off in offs:
                yield from self._walk(self._branch_child(page, off))
        else:
            raise MiniLMDBError(f"unexpected page flags {flags:#x}")

    def keys(self) -> List[bytes]:
        return [k for k, _ in self.items()]

    def get(self, key: bytes) -> Optional[bytes]:
        """B+tree point lookup (binary search per page)."""
        if self.main_root == _INVALID_PGNO:
            return None
        pgno = self.main_root
        for _ in range(self.main_depth + 2):
            page = self._page(pgno)
            _, _, flags, _, _ = struct.unpack_from("<QHHHH", page, 0)
            offs = self._page_nodes(page)
            if flags & P_LEAF:
                for off in offs:
                    k, v = self._leaf_node(page, off)
                    if k == key:
                        return v
                return None
            # branch: entry i covers keys >= its key (entry 0's key is
            # implicit/empty); descend into the last entry whose key <= key
            child = self._branch_child(page, offs[0])
            for off in offs[1:]:
                _, _, _, ksize = struct.unpack_from("<HHHH", page, off)
                k = bytes(page[off + 8:off + 8 + ksize])
                if k <= key:
                    child = self._branch_child(page, off)
                else:
                    break
            pgno = child
        raise MiniLMDBError("B+tree deeper than recorded depth")


# ---------------------------------------------------------------------------
# Minimal writer (fixtures / fallback persistence)
# ---------------------------------------------------------------------------


def _leaf_node_bytes(key: bytes, value: bytes,
                     big_pgno: Optional[int] = None) -> bytes:
    datasize = len(value)
    lo, hi = datasize & 0xFFFF, datasize >> 16
    if big_pgno is not None:
        return (struct.pack("<HHHH", lo, hi, F_BIGDATA, len(key)) + key
                + struct.pack("<Q", big_pgno))
    return struct.pack("<HHHH", lo, hi, 0, len(key)) + key + value


def _branch_node_bytes(key: bytes, child: int) -> bytes:
    lo = child & 0xFFFF
    hi = (child >> 16) & 0xFFFF
    fl = (child >> 32) & 0xFFFF
    return struct.pack("<HHHH", lo, hi, fl, len(key)) + key


def _pack_page(pgno: int, flags: int, nodes: List[bytes],
               page_size: int) -> bytes:
    offs: List[int] = []
    blob = b""
    upper = page_size
    for node in nodes:
        pad = (len(node) + 1) // 2 * 2  # 2-byte node alignment
        upper -= pad
        offs.append(upper)
        blob = node + b"\x00" * (pad - len(node)) + blob
    lower = PAGEHDRSZ + 2 * len(nodes)
    if lower > upper:
        raise MiniLMDBError("page overflow while packing")
    header = struct.pack("<QHHHH", pgno, 0, flags, lower, upper)
    ptrs = struct.pack(f"<{len(offs)}H", *offs)
    body = header + ptrs
    return body + b"\x00" * (upper - len(body)) + blob


def write_minilmdb(path: str, items: Dict[bytes, bytes],
                   page_size: int = 4096) -> str:
    """Write a {key: value} mapping as an LMDB data file readable by both
    `MiniLMDB` and the real library. Keys sorted bytewise (LMDB's default
    ordering); values larger than ~1/2 page go to overflow pages; one
    branch level (capacity ~hundreds of pages of leaves)."""
    if os.path.isdir(path) or path.endswith(os.sep):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, "data.mdb")
    items_sorted = sorted(items.items())
    big_cutoff = page_size // 2

    pages: Dict[int, bytes] = {}
    next_pgno = 2  # 0/1 are meta
    n_overflow = 0

    # 1) place big values on overflow pages
    placed: List[Tuple[bytes, bytes, Optional[int]]] = []
    for k, v in items_sorted:
        if not (0 < len(k) <= 511):
            raise MiniLMDBError(f"bad key length {len(k)}")
        if len(v) >= big_cutoff:
            npages = -(-(PAGEHDRSZ + len(v)) // page_size)
            # the lower/upper slots form the pb_pages u32 union on
            # overflow pages (mdb.c): little-endian page count
            header = struct.pack("<QHHHH", next_pgno, 0, P_OVERFLOW,
                                 npages & 0xFFFF, npages >> 16)
            blob = header + b"\x00" * (PAGEHDRSZ - len(header)) + v
            blob += b"\x00" * (npages * page_size - len(blob))
            pages[next_pgno] = blob
            placed.append((k, v, next_pgno))
            next_pgno += npages
            n_overflow += npages
        else:
            placed.append((k, v, None))

    # 2) fill leaf pages greedily in key order
    leaves: List[Tuple[int, bytes, List[bytes]]] = []  # (pgno, first_key)
    cur_nodes: List[bytes] = []
    cur_first: Optional[bytes] = None
    cur_size = PAGEHDRSZ

    def flush_leaf():
        nonlocal cur_nodes, cur_first, cur_size, next_pgno
        if not cur_nodes:
            return
        leaves.append((next_pgno, cur_first, cur_nodes))
        next_pgno += 1
        cur_nodes, cur_first, cur_size = [], None, PAGEHDRSZ

    for k, v, ov in placed:
        node = _leaf_node_bytes(k, v, ov)
        need = 2 + (len(node) + 1) // 2 * 2
        if cur_size + need > page_size and cur_nodes:
            flush_leaf()
        if cur_first is None:
            cur_first = k
        cur_nodes.append(node)
        cur_size += need
    flush_leaf()

    for pgno, _, nodes in leaves:
        pages[pgno] = _pack_page(pgno, P_LEAF, nodes, page_size)

    # 3) root: the single leaf, or one branch level over the leaves
    depth = 1
    if not leaves:
        root = _INVALID_PGNO
        depth = 0
    elif len(leaves) == 1:
        root = leaves[0][0]
    else:
        depth = 2
        branch_nodes = []
        for i, (pgno, first_key, _) in enumerate(leaves):
            # entry 0's key is ignored by readers; keep it for simplicity
            branch_nodes.append(_branch_node_bytes(first_key, pgno))
        root = next_pgno
        pages[root] = _pack_page(root, P_BRANCH, branch_nodes, page_size)
        next_pgno += 1

    # 4) meta pages (both slots, same txn). In the LMDB format the FREE
    # db's first (pad) field doubles as mm_psize (lmdb's mdb.c:
    # `#define mm_psize mm_dbs[FREE_DBI].md_pad`) — the real library reads
    # the page size from here, so it must be packed, not zero.
    free_db = struct.pack(_DB_FMT, page_size, 0, 0, 0, 0, 0, 0,
                          _INVALID_PGNO)
    main_db = struct.pack(_DB_FMT, 0, 0, depth, 1 if depth > 1 else 0,
                          len(leaves), n_overflow, len(items_sorted), root)
    meta_body = struct.pack("<IIQQ", MDB_MAGIC, MDB_DATA_VERSION, 0,
                            next_pgno * page_size) \
        + free_db + main_db + struct.pack("<QQ", next_pgno - 1, 1)
    for pgno in (0, 1):
        header = struct.pack("<QHHHH", pgno, 0, P_META, 0, 0)
        page = header + meta_body
        pages[pgno] = page + b"\x00" * (page_size - len(page))

    # positional writes: overflow blobs span multiple pgnos under one key
    buf = bytearray(next_pgno * page_size)
    for pgno, blob in pages.items():
        buf[pgno * page_size:pgno * page_size + len(blob)] = blob
    with open(path, "wb") as f:
        f.write(bytes(buf))
    return path
