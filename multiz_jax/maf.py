"""MAF (Multiple Alignment Format) data model and byte-exact I/O.

Re-design of the reference's linked-list MAF layer
(``maf.c``/``maf.h`` in multiz/TBA): components store their aligned text as
NumPy ``uint8`` arrays so that dash counting, slicing, reverse complement and
scoring are vectorized, and so device kernels can consume column statistics
without per-character Python work.

Byte-exact parity targets (reference ``file:line``):
  - parsing: ``maf.c:133-216`` (``mafNext``), ``maf.c:90-130``
    (``parseScoreLine``), ``maf.c:74-87`` (comment echo in ``get_maf_line``)
  - serialization: ``maf.c:251-294`` (``mafWrite``), ``maf.c:231-237``
    (``mafWriteStart``/``mafWriteEnd``), ``maf.c:240-248`` (field widths)
  - src name split: ``multi_util.c:889-925`` (``parseSrcName``/``parseSrcName2``)
"""

from __future__ import annotations

import sys
from typing import Iterator, List, Optional

import numpy as np

DASH = ord("-")

# Sentinel the reference uses for "no score": (double)MIN_INT, maf.c:95.
_NO_SCORE = float(-(1 << 31))


def _split_src(src: str) -> tuple[str, str]:
    """Split ``src`` into (name, contig) at the first '.'.

    Mirrors parseSrcName/parseSrcName2 (multi_util.c:889-925): with no '.'
    or a trailing '.', contig == name.
    """
    i = src.find(".")
    if i < 0 or i == len(src) - 1:
        name = src if i < 0 else src[:i]
        return name, name
    return src[:i], src[i + 1 :]


class Comp:
    """One row of a MAF block (struct mafComp, maf.h:42-57).

    A plain ``__slots__`` class (not a dataclass): blocks are created and
    sliced millions of times per chromosome-scale run, and constructor
    cost is a measured pipeline bottleneck. Texts are uint8 arrays (often
    views into a parent block's buffer) that are REPLACED, never mutated
    in place — the invariant that makes view-slicing, text sharing across
    block copies, and the identity-keyed coordinate caches sound."""

    __slots__ = (
        "src", "start", "size", "strand", "src_size", "text", "paralog",
        "_pm", "_nd",
    )

    def __init__(
        self,
        src: str,
        start: int,
        size: int,
        strand: str,
        src_size: int,
        text: np.ndarray,
        paralog: str = "s",  # 's' singleton | 'a' amplifier | 'c' copy
    ):
        self.src = src
        self.start = start
        self.size = size
        self.strand = strand
        self.src_size = src_size
        self.text = text
        self.paralog = paralog
        self._pm = None
        self._nd = None

    @property
    def name(self) -> str:
        return _split_src(self.src)[0]

    @property
    def contig(self) -> str:
        return _split_src(self.src)[1]

    @property
    def end(self) -> int:
        """One past the last position (start + size)."""
        return self.start + self.size

    def __repr__(self) -> str:
        return (
            f"Comp(src={self.src!r}, start={self.start}, size={self.size}, "
            f"strand={self.strand!r}, src_size={self.src_size})"
        )

    def text_str(self) -> str:
        return self.text.tobytes().decode("latin-1")

    def nondash(self) -> np.ndarray:
        return self.text != DASH

    def copy(self, *, text: Optional[np.ndarray] = None) -> "Comp":
        c = Comp.__new__(Comp)
        c.src = self.src
        c.start = self.start
        c.size = self.size
        c.strand = self.strand
        c.src_size = self.src_size
        c.paralog = self.paralog
        if text is None:
            c.text = self.text.copy()
            c._pm = None
            c._nd = None
        else:
            c.text = text
            if text is self.text:  # shared text: coordinate caches carry
                c._pm = self._pm
                c._nd = self._nd
            else:
                c._pm = None
                c._nd = None
        return c

    def nondash_before(self, col: int) -> int:
        """#non-dash chars in text[:col] (O(1) via the cached pos_map)."""
        return 0 if col <= 0 else int(self.pos_map()[col - 1])

    def pos_map(self) -> np.ndarray:
        """cumulative non-dash count; pos_map[col] = #non-dash in text[:col+1].

        Replaces the O(textSize) scans of mafPos2Col (multi_util.c:633-645)
        with one vectorized cumsum (the ``mafPosMap`` the C declares but
        never fills, maf.h:50). Cached per text OBJECT: text buffers are
        replaced, never mutated in place (the invariant pre_yama_gen's
        snapshot also relies on), so identity is a sound cache key.
        """
        cached = self._pm
        if cached is not None and cached[0] is self.text:
            return cached[1]
        pm = np.cumsum(self.text != DASH)
        self._pm = (self.text, pm)
        return pm

    def nd_idx(self) -> np.ndarray:
        """Columns of the non-dash characters (the inverse map of
        pos_map): nd_idx[k] = column of the (k+1)-th non-dash char.
        Cached per text object like pos_map; makes pos2col O(1)."""
        cached = self._nd
        if cached is not None and cached[0] is self.text:
            return cached[1]
        nd = np.flatnonzero(self.text != DASH)
        self._nd = (self.text, nd)
        return nd


class Ali:
    """One MAF block (struct mafAli, maf.h:29-37).

    ``score`` may be LAZY (``set_lazy_score``): the merge scan truncates
    blocks repeatedly (keep_ali) and the O(rows^2 * len) sum-of-pairs
    rescore is only observable if the block is eventually written — a
    block truncated k times pays one scoring instead of k."""

    __slots__ = ("comps", "_score", "_score_fn")

    def __init__(
        self,
        comps: Optional[List[Comp]] = None,
        score: Optional[float] = None,  # None <=> reference (double)MIN_INT
    ):
        self.comps = [] if comps is None else comps
        self._score = score
        self._score_fn = None

    @property
    def score(self) -> Optional[float]:
        fn = self._score_fn
        if fn is not None:
            self._score_fn = None
            self._score = fn()
        return self._score

    @score.setter
    def score(self, v: Optional[float]) -> None:
        self._score = v
        self._score_fn = None

    def set_lazy_score(self, fn) -> None:
        """Defer scoring until ``score`` is first read. The callable
        must capture state that no later code mutates (keep_ali outputs
        qualify: fresh Ali, comps never edited afterwards)."""
        self._score = None
        self._score_fn = fn

    @property
    def text_size(self) -> int:
        return 0 if not self.comps else int(self.comps[0].text.shape[0])

    @property
    def nrow(self) -> int:
        return len(self.comps)

    def __repr__(self) -> str:
        return f"Ali(nrow={len(self.comps)}, score={self.score})"

    def copy(self) -> "Ali":
        return Ali(comps=[c.copy() for c in self.comps], score=self.score)

    def copy_shared(self) -> "Ali":
        """Fresh Ali + fresh Comp objects sharing the text buffers (and
        their coordinate caches). Safe under the replace-don't-mutate
        text invariant; replaces the deep copies the in-memory tool
        wrappers used to take per invocation."""
        return Ali(
            comps=[c.copy(text=c.text) for c in self.comps],
            score=self.score,
        )

    def texts(self) -> np.ndarray:
        """(nrow, text_size) uint8 matrix of the block."""
        return np.stack([c.text for c in self.comps], axis=0)


def pos2col(comp: Comp, pos: int) -> int:
    """Column of sequence position ``pos`` on ``comp`` (multi_util.c:633-645).

    pos and col are 0-based; pos must lie in [start, start+size).
    """
    k = pos - comp.start
    if k < 0 or k >= comp.size:
        raise ValueError(
            f"pos2col: {pos} not in {comp.start}-{comp.start + comp.size - 1}"
        )
    # column of the (k+1)-th non-dash character
    return int(comp.nd_idx()[k])


def col_back_over_dashes(comp: Comp, pos: int) -> int:
    """pos2col(comp, pos), then walk left over dash columns: the column
    just after the previous non-dash char (0 if none). Replaces the
    per-character ``while t[cb-1] == '-': cb -= 1`` walks of the merge
    scan (multiz.c:120-122) with two O(1) lookups."""
    k = pos - comp.start
    if k < 0 or k >= comp.size:
        raise ValueError(
            f"pos2col: {pos} not in {comp.start}-{comp.start + comp.size - 1}"
        )
    if k == 0:
        return 0
    return int(comp.nd_idx()[k - 1]) + 1


def col_fwd_over_dashes(comp: Comp, pos: int) -> int:
    """pos2col(comp, pos), then walk right over dash columns: the column
    just before the next non-dash char (text_size-1 if none)."""
    k = pos - comp.start
    if k < 0 or k >= comp.size:
        raise ValueError(
            f"pos2col: {pos} not in {comp.start}-{comp.start + comp.size - 1}"
        )
    nd = comp.nd_idx()
    if k + 1 >= nd.shape[0]:
        return int(comp.text.shape[0]) - 1
    return int(nd[k + 1]) - 1


def col2pos_after(comp: Comp, col: int) -> int:
    """First sequence position at or after column ``col`` (multi_util.c:846-855).

    Returns -1 when past the end of the row.
    """
    before = int(np.count_nonzero(comp.text[:col] != DASH))
    pos = comp.start + before
    if pos > comp.start + comp.size - 1:
        return -1
    return pos


def col2pos_before(comp: Comp, col: int) -> int:
    """Last sequence position at or before column ``col`` (multi_util.c:858-866).

    Returns -1 when before the start of the row.
    """
    upto = int(np.count_nonzero(comp.text[: col + 1] != DASH))
    pos = comp.start - 1 + upto
    if pos < comp.start:
        return -1
    return pos


# --------------------------------------------------------------------------
# Parsing
# --------------------------------------------------------------------------


class MafParseError(Exception):
    pass


def parse_maf_bytes(
    data: bytes,
    *,
    verbose: bool = False,
    echo=None,
    file_name: str = "<bytes>",
) -> List[Ali]:
    """Parse a whole MAF file's bytes into a list of blocks.

    Mirrors mafOpen + mafNext (maf.c:11-216): validates the ``##maf`` header,
    echoes '#' comment lines not containing "eof" to ``echo`` when
    ``verbose`` (maf.c:80-83), skips non-'s' component lines, and applies the
    reference's size/coordinate sanity checks.
    """
    if echo is None:
        echo = sys.stdout
    lines = data.split(b"\n")
    # Re-attach newlines conceptually: a final empty chunk after trailing \n
    if lines and lines[-1] == b"":
        lines.pop()
    if not lines:
        raise MafParseError(f"empty file {file_name}")
    first = lines[0]
    if not first.startswith(b"##maf version="):
        raise MafParseError(f"improper maf header line: {first!r}")

    alis: List[Ali] = []
    n = len(lines)
    i = 1
    line_nbr = 0

    def next_content_line(i: int) -> tuple[int, Optional[bytes]]:
        """get_maf_line: skip/echo '#' lines, return next line w/ len>1, or a
        blank line, or EOF. Returned index points past the returned line."""
        nonlocal line_nbr
        while i < n:
            ln = lines[i]
            i += 1
            if len(ln) <= 0:  # blank line ("\n" -> length-1 in C, here b"")
                return i, ln
            line_nbr += 1
            if ln.startswith(b"#"):
                if verbose and b"eof" not in ln:
                    echo.write(ln.decode("latin-1") + "\n")
                continue
            return i, ln
        return i, None

    while True:
        # outer skip: blank / space-led lines between blocks (maf.c:142-144)
        header = None
        while True:
            i, ln = next_content_line(i)
            if ln is None:
                return alis
            if len(ln) == 0 or ln[:1] in (b"\n", b" "):
                continue
            header = ln
            break
        if not header.startswith(b"a"):
            raise MafParseError(
                f"Expecting 'a (score=xxx)' in file {file_name}: {header!r}"
            )
        ali = Ali()
        text_size = -1
        # component lines until blank/space/EOF (maf.c:164-212)
        while True:
            i, ln = next_content_line(i)
            if ln is None or len(ln) == 0 or ln[:1] == b" ":
                break
            if not ln.startswith(b"s"):
                continue  # 'i'/'e'/'q' rows skipped (maf.c:169-170)
            parts = ln.split()
            if len(parts) != 7:
                raise MafParseError(f"bad component in {file_name}: {ln!r}")
            _, src_b, start_b, size_b, strand_b, srcsize_b, text_b = parts
            try:
                start = int(start_b)
                size = int(size_b)
                src_size = int(srcsize_b)
            except ValueError:
                raise MafParseError(f"bad component in {file_name}: {ln!r}")
            strand = strand_b.decode("latin-1")
            if len(strand) != 1:
                raise MafParseError(f"bad strand in {file_name}: {ln!r}")
            text = np.frombuffer(text_b, dtype=np.uint8).copy()
            c = Comp(
                src=src_b.decode("latin-1"),
                start=start,
                size=size,
                strand=strand,
                src_size=src_size,
                text=text,
            )
            if text_size < 0:
                text_size = text.shape[0]
            elif text_size != text.shape[0]:
                raise MafParseError(
                    f"{file_name}: inconsistent row size: {ln!r}"
                )
            if src_size <= 0 or size <= 0:
                raise MafParseError(f"Size <= 0 in {file_name}: {ln!r}")
            if start < 0 or start + size > src_size:
                raise MafParseError(f"Bad coordinates in {file_name}: {ln!r}")
            actual = int(np.count_nonzero(text != DASH))
            if actual != size:
                raise MafParseError(
                    f"Actual size {actual}, claimed size {size} in "
                    f"{file_name}: {ln!r}"
                )
            ali.comps.append(c)
        _parse_score_line(header, ali)
        alis.append(ali)


def _parse_score_line(header: bytes, ali: Ali) -> None:
    """parseScoreLine (maf.c:90-130): score= / amplifier= / copy= tokens."""
    ali.score = None
    cur = 0
    for tok in header[1:].split():
        if tok.startswith(b"score="):
            try:
                ali.score = float(tok[6:])
            except ValueError:
                ali.score = 0.0
        elif tok.startswith(b"amplifier="):
            # C only walks the comp list forward (maf.c:111-116)
            cur = max(cur, int(tok[10:]))
            if cur < len(ali.comps):
                ali.comps[cur].paralog = "a"
        elif tok.startswith(b"copy="):
            cur = max(cur, int(tok[5:]))
            if cur < len(ali.comps):
                ali.comps[cur].paralog = "c"


def read_maf(path: str, *, verbose: bool = False, echo=None) -> List[Ali]:
    """mafReadAll equivalent (maf.c:219-229)."""
    if path == "/dev/stdin" or path == "-":
        data = sys.stdin.buffer.read()
    else:
        with open(path, "rb") as fh:
            data = fh.read()
    return parse_maf_bytes(data, verbose=verbose, echo=echo, file_name=path)


# --------------------------------------------------------------------------
# Serialization
# --------------------------------------------------------------------------


def _digits(x: int) -> int:
    """digitsBaseTen (maf.c:240-248)."""
    if x < 0:
        raise ValueError(f"digitsBaseTen: negative argument {x}")
    d = 1
    while x >= 10:
        x //= 10
        d += 1
    return d


def format_score(score: float) -> str:
    """C's %3.1f."""
    return f"{score:3.1f}"


def write_start(out, scoring: str) -> None:
    out.write(f"##maf version=1 scoring={scoring}\n")


def write_end(out) -> None:
    out.write("##eof maf\n")


def format_ali(a: Ali) -> str:
    """Byte-identical port of mafWrite (maf.c:251-294)."""
    parts = ["a"]
    if a.score is not None and a.score != _NO_SCORE:
        parts.append(f" score={format_score(a.score)}")
    for row, c in enumerate(a.comps):
        if c.paralog == "a":
            parts.append(f" amplifier={row}")
        elif c.paralog == "c":
            parts.append(f" copy={row}")
        elif c.paralog != "s":
            raise ValueError(f"Wrong paralog character: {c.paralog!r}")
    parts.append("\n")
    src_w = start_w = size_w = srcsize_w = 0
    for c in a.comps:
        src_w = max(src_w, len(c.src))
        start_w = max(start_w, _digits(c.start))
        size_w = max(size_w, _digits(c.size))
        srcsize_w = max(srcsize_w, _digits(c.src_size))
    for c in a.comps:
        name, chrom = _split_src(c.src)
        src = name if name == chrom else f"{name}.{chrom}"
        parts.append(
            f"s {src:<{src_w}} {c.start:>{start_w}d} {c.size:>{size_w}d} "
            f"{c.strand} {c.src_size:>{srcsize_w}d} {c.text_str()}\n"
        )
    parts.append("\n")
    return "".join(parts)


def write_ali(out, a: Ali) -> None:
    out.write(format_ali(a))


def write_maf(path_or_file, alis: List[Ali], scoring: str = "multiz") -> None:
    close = False
    if isinstance(path_or_file, str):
        out = open(path_or_file, "w")
        close = True
    else:
        out = path_or_file
    try:
        write_start(out, scoring)
        for a in alis:
            write_ali(out, a)
        write_end(out)
    finally:
        if close:
            out.close()
