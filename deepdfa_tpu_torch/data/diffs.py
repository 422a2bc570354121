"""Changed-line labeling from before/after function pairs.

The reference shells out to `git diff --no-index` per example and parses
hunk headers (DDFA/sastvd/helpers/git.py:12-165) to get added/removed line
numbers; statement labels are then "removed lines + lines data/control
dependent on added lines" (evaluate.py:194-236). Here the diff is computed
in-process (no subprocess per example) with git's own xdiff pipeline,
freshly implemented: bidirectional middle-snake Myers (xdl_split
semantics, so the CHOICE among equally minimal edit scripts matches
git's) followed by change compaction — group sliding with merge,
alignment to the other file's changes, and the indent-heuristic split
scoring that is on by default in modern git (xdl_change_compact). Together with the
xdl_cleanup_records pre-discard and the xdl_split cost heuristics, hunk
boundaries — and therefore vuln-line labels — match `git diff
--no-index` byte-for-byte on EVERY fuzz corpus: 297/297 adversarial
duplicate-line soups, 297/297 indented soups, 297/297 C-like edit
scripts, 29/29 thousand-line rewrites (scripts/fuzz_diffs_vs_git.py,
docs/diff_fuzz_report.json; goldens in tests/goldens/diff_labels.json).

The port's copy of the reference's `deepdfa_tpu/data/diffs.py`.
"""

from __future__ import annotations


_BIG = 1 << 60
_SNAKE_CNT = 20  # XDL_SNAKE_CNT
_HEUR_MIN_COST = 256  # XDL_HEUR_MIN_COST
_K_HEUR = 4  # XDL_K_HEUR
_MAX_COST_MIN = 256  # XDL_MAX_COST_MIN


def _bogosqrt(n: int) -> int:
    """git's shift-based integer sqrt overestimate (xdl_bogosqrt)."""
    i = 1
    while n > 0:
        i <<= 1
        n >>= 2
    return i


def _xdl_split(
    a: list[str],
    b: list[str],
    off1: int,
    lim1: int,
    off2: int,
    lim2: int,
    need_min: bool,
    mxcost: int,
) -> tuple[int, int, bool, bool]:
    """Find a split point the way git's xdl_split does; returns
    (i1, i2, min_lo, min_hi) — the flags say whether each half must be
    searched minimally (they come back False for a heuristic split).

    Simultaneous forward and backward D-path searches return the first
    overlap; matching git's direction interleaving and tie-breaks
    (forward prefers the deletion-first diagonal on ties, backward the
    mirror) is what makes the chosen edit script — among several equally
    minimal ones — identical to git's on ambiguous duplicate-heavy
    input. Because `git diff` never sets XDF_NEED_MINIMAL, its two
    cost heuristics apply and are replicated here: past _HEUR_MIN_COST
    edits a long-snake diagonal that is "interesting enough"
    (_K_HEUR x cost) is taken immediately, and past `mxcost` the
    furthest-reaching diagonals are taken outright."""
    dmin, dmax = off1 - lim2, lim1 - off2
    fmid, bmid = off1 - off2, lim1 - lim2
    odd = (fmid - bmid) & 1
    kvdf = {fmid: off1, fmid - 1: -1, fmid + 1: -1}
    kvdb = {bmid: lim1, bmid - 1: _BIG, bmid + 1: _BIG}
    fmin = fmax = fmid
    bmin = bmax = bmid
    ec = 1
    while True:
        got_snake = False
        # one forward sweep
        if fmin > dmin:
            fmin -= 1
            kvdf[fmin - 1] = -1
        else:
            fmin += 1
        if fmax < dmax:
            fmax += 1
            kvdf[fmax + 1] = -1
        else:
            fmax -= 1
        for d in range(fmax, fmin - 1, -2):
            if kvdf[d - 1] >= kvdf[d + 1]:
                i1 = kvdf[d - 1] + 1
            else:
                i1 = kvdf[d + 1]
            prev1 = i1
            i2 = i1 - d
            while i1 < lim1 and i2 < lim2 and a[i1] == b[i2]:
                i1 += 1
                i2 += 1
            if i1 - prev1 > _SNAKE_CNT:
                got_snake = True
            kvdf[d] = i1
            if odd and bmin <= d <= bmax and kvdb.get(d, _BIG) <= i1:
                return i1, i2, True, True
        # one backward sweep
        if bmin > dmin:
            bmin -= 1
            kvdb[bmin - 1] = _BIG
        else:
            bmin += 1
        if bmax < dmax:
            bmax += 1
            kvdb[bmax + 1] = _BIG
        else:
            bmax -= 1
        for d in range(bmax, bmin - 1, -2):
            if kvdb[d - 1] < kvdb[d + 1]:
                i1 = kvdb[d - 1]
            else:
                i1 = kvdb[d + 1] - 1
            prev1 = i1
            i2 = i1 - d
            while i1 > off1 and i2 > off2 and a[i1 - 1] == b[i2 - 1]:
                i1 -= 1
                i2 -= 1
            if prev1 - i1 > _SNAKE_CNT:
                got_snake = True
            kvdb[d] = i1
            if not odd and fmin <= d <= fmax and i1 <= kvdf.get(d, -1):
                return i1, i2, True, True

        if need_min:
            ec += 1
            continue

        # heuristic 1 (git's "got_snake" path): past _HEUR_MIN_COST
        # edits, sample current diagonals for one whose distance from
        # the corner (minus its off-mid penalty) is interesting enough
        # (> _K_HEUR x cost) and which sits at the end of a >=_SNAKE_CNT
        # snake; split there, searching only the snake-adjacent half
        # minimally.
        if got_snake and ec > _HEUR_MIN_COST:
            best = 0
            spl_i1 = spl_i2 = 0
            for d in range(fmax, fmin - 1, -2):
                dd = d - fmid if d > fmid else fmid - d
                i1 = kvdf[d]
                i2 = i1 - d
                v = (i1 - off1) + (i2 - off2) - dd
                if (
                    v > _K_HEUR * ec
                    and v > best
                    and off1 + _SNAKE_CNT <= i1 < lim1
                    and off2 + _SNAKE_CNT <= i2 < lim2
                ):
                    k = 1
                    while a[i1 - k] == b[i2 - k]:
                        if k == _SNAKE_CNT:
                            best = v
                            spl_i1 = i1 - k
                            spl_i2 = i2 - k
                            break
                        k += 1
            if best > 0:
                return spl_i1, spl_i2, True, False

            best = 0
            for d in range(bmax, bmin - 1, -2):
                dd = d - bmid if d > bmid else bmid - d
                i1 = kvdb[d]
                i2 = i1 - d
                v = (lim1 - i1) + (lim2 - i2) - dd
                if (
                    v > _K_HEUR * ec
                    and v > best
                    and off1 < i1 <= lim1 - _SNAKE_CNT
                    and off2 < i2 <= lim2 - _SNAKE_CNT
                ):
                    k = 0
                    while a[i1 + k] == b[i2 + k]:
                        if k == _SNAKE_CNT - 1:
                            best = v
                            spl_i1 = i1
                            spl_i2 = i2
                            break
                        k += 1
            if best > 0:
                return spl_i1, spl_i2, False, True

        # heuristic 2: enough is enough — past mxcost take the
        # furthest-reaching forward or backward diagonal outright
        if ec >= mxcost:
            fbest = fbest1 = -1
            for d in range(fmax, fmin - 1, -2):
                i1 = min(kvdf[d], lim1)
                i2 = i1 - d
                if lim2 < i2:
                    i1 = lim2 + d
                    i2 = lim2
                if fbest < i1 + i2:
                    fbest = i1 + i2
                    fbest1 = i1
            bbest = bbest1 = _BIG
            for d in range(bmax, bmin - 1, -2):
                i1 = max(off1, kvdb[d])
                i2 = i1 - d
                if i2 < off2:
                    i1 = off2 + d
                    i2 = off2
                if i1 + i2 < bbest:
                    bbest = i1 + i2
                    bbest1 = i1
            if (lim1 + lim2) - bbest < fbest - (off1 + off2):
                return fbest1, fbest - fbest1, True, False
            return bbest1, bbest - bbest1, False, True
        ec += 1


_KPDIS_RUN = 4  # XDL_KPDIS_RUN
_MAX_EQLIMIT = 1024  # XDL_MAX_EQLIMIT
_SIMSCAN_WINDOW = 100  # XDL_SIMSCAN_WINDOW


def _clean_mmatch(dis: dict[int, int], i: int, s: int, e: int) -> bool:
    """git's xdl_clean_mmatch: discard a too-frequent line (dis[i]==2)
    only when it sits inside a run of no-match (0) / multi-match (2)
    lines with no-match lines on BOTH sides and the run is dominated by
    no-match lines. s/e are inclusive window bounds."""
    if i - s > _SIMSCAN_WINDOW:
        s = i - _SIMSCAN_WINDOW
    if e - i > _SIMSCAN_WINDOW:
        e = i + _SIMSCAN_WINDOW
    r, rdis0, rpdis0 = 1, 0, 1
    while i - r >= s:
        d = dis[i - r]
        if d == 0:
            rdis0 += 1
        elif d == 2:
            rpdis0 += 1
        else:
            break
        r += 1
    if rdis0 == 0:
        return False
    r, rdis1, rpdis1 = 1, 0, 1
    while i + r <= e:
        d = dis[i + r]
        if d == 0:
            rdis1 += 1
        elif d == 2:
            rpdis1 += 1
        else:
            break
        r += 1
    if rdis1 == 0:
        return False
    rdis0 += rdis1
    rpdis0 += rpdis1
    return rpdis0 * _KPDIS_RUN < rpdis0 + rdis0


def _cleanup_records(
    a: list[str], b: list[str], a0: int, a1: int, b0: int, b1: int
) -> tuple[list[int], list[int]]:
    """git's xdl_cleanup_records: within the trimmed windows, pre-discard
    lines that have no match in the other file or appear there too often
    (>= bogosqrt of the file size); discarded lines are marked changed
    upfront and excluded from the Myers search. Occurrence counts span
    the WHOLE other file (the classifier counts every record), while the
    keep/discard scan runs over the trimmed window only. Returns the
    surviving indices per side."""
    from collections import Counter

    count_in_b = Counter(b)
    count_in_a = Counter(a)

    def classify(lines, lo, hi, other_counts, mlim) -> dict[int, int]:
        dis = {}
        for i in range(lo, hi):
            nm = other_counts.get(lines[i], 0)
            dis[i] = 0 if nm == 0 else (2 if nm >= mlim else 1)
        return dis

    def keep(lines, lo, hi, dis) -> list[int]:
        return [
            i
            for i in range(lo, hi)
            if dis[i] == 1
            or (dis[i] == 2 and not _clean_mmatch(dis, i, lo, hi - 1))
        ]

    mlim_a = min(_bogosqrt(len(a)), _MAX_EQLIMIT)
    mlim_b = min(_bogosqrt(len(b)), _MAX_EQLIMIT)
    dis_a = classify(a, a0, a1, count_in_b, mlim_a)
    dis_b = classify(b, b0, b1, count_in_a, mlim_b)
    return keep(a, a0, a1, dis_a), keep(b, b0, b1, dis_b)


def _xdl_diff_core(
    a: list[str], b: list[str], rchg1: list[bool], rchg2: list[bool],
    mxcost: int,
) -> None:
    """xdl_recs_cmp divide-and-conquer over (a, b), marking rchg in
    place; explicit work stack (Big-Vul functions can be thousands of
    lines; Python recursion is not). Each box is first shrunk over its
    boundary snakes, then split at the middle snake and both halves
    pushed."""
    stack = [(0, len(a), 0, len(b), False)]
    while stack:
        off1, lim1, off2, lim2, need_min = stack.pop()
        while off1 < lim1 and off2 < lim2 and a[off1] == b[off2]:
            off1 += 1
            off2 += 1
        while off1 < lim1 and off2 < lim2 and a[lim1 - 1] == b[lim2 - 1]:
            lim1 -= 1
            lim2 -= 1
        if off1 == lim1:
            for j in range(off2, lim2):
                rchg2[j] = True
        elif off2 == lim2:
            for i in range(off1, lim1):
                rchg1[i] = True
        else:
            i1, i2, min_lo, min_hi = _xdl_split(
                a, b, off1, lim1, off2, lim2, need_min, mxcost
            )
            stack.append((off1, i1, off2, i2, min_lo))
            stack.append((i1, lim1, i2, lim2, min_hi))


def _xdl_diff(a: list[str], b: list[str]) -> tuple[list[bool], list[bool]]:
    """git-identical diff: changed-line maps for (a, b).

    Pipeline order matches xdl_optimize_ctxs + xdl_do_diff: trim common
    head/tail (xdl_trim_ends), pre-discard no-match / too-frequent lines
    (xdl_cleanup_records — they are marked changed and excluded from the
    search), run the middle-snake divide-and-conquer over the surviving
    subsequences, and map the changed flags back. mxcost is bogosqrt of
    the SURVIVING diagonal count (xdl_do_diff uses nreff), floored at
    _MAX_COST_MIN."""
    rchg1 = [False] * len(a)
    rchg2 = [False] * len(b)
    a0, b0 = 0, 0
    a1, b1 = len(a), len(b)
    while a0 < a1 and b0 < b1 and a[a0] == b[b0]:
        a0 += 1
        b0 += 1
    while a0 < a1 and b0 < b1 and a[a1 - 1] == b[b1 - 1]:
        a1 -= 1
        b1 -= 1
    keep_a, keep_b = _cleanup_records(a, b, a0, a1, b0, b1)
    kept_a, kept_b = set(keep_a), set(keep_b)
    for i in range(a0, a1):
        if i not in kept_a:
            rchg1[i] = True
    for j in range(b0, b1):
        if j not in kept_b:
            rchg2[j] = True
    ra = [a[i] for i in keep_a]
    rb = [b[j] for j in keep_b]
    sub1 = [False] * len(ra)
    sub2 = [False] * len(rb)
    mxcost = max(_bogosqrt(len(ra) + len(rb) + 3), _MAX_COST_MIN)
    _xdl_diff_core(ra, rb, sub1, sub2, mxcost)
    for k, i in enumerate(keep_a):
        if sub1[k]:
            rchg1[i] = True
    for k, j in enumerate(keep_b):
        if sub2[k]:
            rchg2[j] = True
    return rchg1, rchg2


def _insert_positions(bchg: list[bool], achg: list[bool]) -> set[int]:
    """0-based before-file positions where after-file insertions land,
    derived from the two changed maps by walking the matched unchanged
    pairs (the common subsequence is identical in both files)."""
    ins: set[int] = set()
    i = j = 0
    while j < len(achg) or i < len(bchg):
        if i < len(bchg) and bchg[i]:
            i += 1
            continue
        if j < len(achg) and achg[j]:
            ins.add(i)
            j += 1
            continue
        i += 1
        j += 1
    return ins


# ---------------------------------------------------------------------------
# git-xdiff change compaction.
#
# Raw Myers output is ambiguous wherever a changed run can slide over
# identical neighbouring lines; git normalizes it in xdl_change_compact
# (xdiff/xdiffi.c): each group of changed lines is slid up/down as far as
# it goes (merging with groups it touches), then its final position is
# chosen by (1) aligning with a changed group in the OTHER file if any
# slide position does, else (2) the indent-heuristic split score (on by
# default since git 2.14, diff.indentHeuristic), else (3) left fully
# slid down. This is a fresh Python implementation of that published
# algorithm so vuln-line labels match `git diff --no-index` byte-for-byte
# even on duplicate-line runs (the round-3 adversarial tail).

_MAX_SLIDING = 100  # INDENT_HEURISTIC_MAX_SLIDING: bound the split scan
_MAX_INDENT = 200
_MAX_BLANKS = 20
_START_OF_FILE_PENALTY = 1
_END_OF_FILE_PENALTY = 21
_TOTAL_BLANK_WEIGHT = -30
_POST_BLANK_WEIGHT = 6
_RELATIVE_INDENT_PENALTY = -4
_RELATIVE_INDENT_WITH_BLANK_PENALTY = 10
_RELATIVE_OUTDENT_PENALTY = 24
_RELATIVE_OUTDENT_WITH_BLANK_PENALTY = 17
_RELATIVE_DEDENT_PENALTY = 23
_RELATIVE_DEDENT_WITH_BLANK_PENALTY = 17
_INDENT_WEIGHT = 60


def _get_indent(line: str) -> int:
    """Visual indent of a line (tab = next multiple of 8); -1 if blank.
    Matches git's get_indent: OTHER whitespace (\\r \\f \\v — ASCII
    isspace, e.g. the \\r of a CRLF file after \\n-splitting) is skipped
    without advancing the column, and an all-whitespace line is blank."""
    ret = 0
    for ch in line:
        if ch == " ":
            ret += 1
        elif ch == "\t":
            ret += 8 - ret % 8
        elif ch in "\r\f\v\n":
            pass  # whitespace, but not indentation
        else:
            return min(ret, _MAX_INDENT)
        if ret >= _MAX_INDENT:
            return _MAX_INDENT
    return -1


def _score_split(lines: list[str], split: int, score: list[int]) -> None:
    """Accumulate the badness of splitting just before lines[split] into
    score = [effective_indent, penalty] (both smaller = better)."""
    n = len(lines)
    if split >= n:
        end_of_file = True
        indent = -1
    else:
        end_of_file = False
        indent = _get_indent(lines[split])

    pre_blank, pre_indent = 0, -1
    for i in range(split - 1, -1, -1):
        pre_indent = _get_indent(lines[i])
        if pre_indent != -1:
            break
        pre_blank += 1
        if pre_blank == _MAX_BLANKS:
            pre_indent = 0
            break

    post_blank, post_indent = 0, -1
    for i in range(split + 1, n):
        post_indent = _get_indent(lines[i])
        if post_indent != -1:
            break
        post_blank += 1
        if post_blank == _MAX_BLANKS:
            post_indent = 0
            break

    if pre_indent == -1 and pre_blank == 0:
        score[1] += _START_OF_FILE_PENALTY
    if end_of_file:
        score[1] += _END_OF_FILE_PENALTY

    this_post_blank = 1 + post_blank if indent == -1 else 0
    total_blank = pre_blank + this_post_blank
    score[1] += _TOTAL_BLANK_WEIGHT * total_blank
    score[1] += _POST_BLANK_WEIGHT * this_post_blank

    eff_indent = indent if indent != -1 else post_indent
    any_blanks = total_blank != 0
    score[0] += eff_indent

    if eff_indent == -1 or pre_indent == -1:
        pass
    elif eff_indent > pre_indent:
        score[1] += (
            _RELATIVE_INDENT_WITH_BLANK_PENALTY
            if any_blanks
            else _RELATIVE_INDENT_PENALTY
        )
    elif eff_indent == pre_indent:
        pass
    elif post_indent != -1 and post_indent > eff_indent:
        # outdented vs predecessor but followed by deeper code: likely
        # the start of a block (e.g. an `else`)
        score[1] += (
            _RELATIVE_OUTDENT_WITH_BLANK_PENALTY
            if any_blanks
            else _RELATIVE_OUTDENT_PENALTY
        )
    else:
        # probably the end of a block
        score[1] += (
            _RELATIVE_DEDENT_WITH_BLANK_PENALTY
            if any_blanks
            else _RELATIVE_DEDENT_PENALTY
        )


def _score_cmp(s1: list[int], s2: list[int]) -> int:
    cmp_indents = (s1[0] > s2[0]) - (s1[0] < s2[0])
    return _INDENT_WEIGHT * cmp_indents + (s1[1] - s2[1])


class _Group:
    """[start, end) run of changed lines; empty groups sit between the
    matched unchanged lines, which is what keeps the two files' group
    cursors in lockstep (each file has the same unchanged-line count)."""

    __slots__ = ("start", "end")

    def __init__(self, chg: list[bool]):
        self.start = 0
        e = 0
        while e < len(chg) and chg[e]:
            e += 1
        self.end = e


def _group_next(chg: list[bool], g: _Group) -> bool:
    if g.end == len(chg):
        return False
    g.start = g.end + 1
    e = g.start
    while e < len(chg) and chg[e]:
        e += 1
    g.end = e
    return True


def _group_previous(chg: list[bool], g: _Group) -> bool:
    if g.start == 0:
        return False
    g.end = g.start - 1
    s = g.end
    while s > 0 and chg[s - 1]:
        s -= 1
    g.start = s
    return True


def _group_slide_up(chg: list[bool], lines: list[str], g: _Group) -> bool:
    if g.start > 0 and lines[g.start - 1] == lines[g.end - 1]:
        g.start -= 1
        g.end -= 1
        chg[g.start] = True
        chg[g.end] = False
        while g.start > 0 and chg[g.start - 1]:
            g.start -= 1
        return True
    return False


def _group_slide_down(chg: list[bool], lines: list[str], g: _Group) -> bool:
    if g.end < len(lines) and lines[g.start] == lines[g.end]:
        chg[g.start] = False
        chg[g.end] = True
        g.start += 1
        g.end += 1
        while g.end < len(lines) and chg[g.end]:
            g.end += 1
        return True
    return False


def _change_compact(
    chg: list[bool], lines: list[str], ochg: list[bool]
) -> None:
    """Normalize `chg` in place the way xdl_change_compact does; `ochg`
    is the other file's (read-only) changed map, used to align sliding
    groups with the other side's changes."""
    g = _Group(chg)
    go = _Group(ochg)
    while True:
        if g.end != g.start:
            while True:
                groupsize = g.end - g.start
                end_matching_other = -1
                while _group_slide_up(chg, lines, g):
                    if not _group_previous(ochg, go):
                        raise AssertionError("group sync broken sliding up")
                earliest_end = g.end
                if go.end > go.start:
                    end_matching_other = g.end
                while _group_slide_down(chg, lines, g):
                    if not _group_next(ochg, go):
                        raise AssertionError("group sync broken sliding down")
                    if go.end > go.start:
                        end_matching_other = g.end
                if groupsize == g.end - g.start:
                    break  # no merge happened; the slide range is final
            if g.end == earliest_end:
                pass  # no freedom to shift
            elif end_matching_other != -1:
                # align with the last other-file change group any slide
                # position lines up with
                while go.end == go.start:
                    if not _group_slide_up(chg, lines, g):
                        raise AssertionError("match disappeared")
                    if not _group_previous(ochg, go):
                        raise AssertionError("sync broken sliding to match")
            else:
                # indent heuristic: a group implies two splits (above and
                # below it); score every reachable shift and keep the
                # best, later shifts winning ties
                groupsize = g.end - g.start
                best_shift = -1
                best_score = [0, 0]
                for shift in range(
                    max(earliest_end, g.end - _MAX_SLIDING), g.end + 1
                ):
                    score = [0, 0]
                    _score_split(lines, shift - groupsize, score)
                    _score_split(lines, shift, score)
                    if best_shift == -1 or _score_cmp(score, best_score) <= 0:
                        best_score = score
                        best_shift = shift
                while g.end > best_shift:
                    if not _group_slide_up(chg, lines, g):
                        raise AssertionError("best shift unreachable")
                    if not _group_previous(ochg, go):
                        raise AssertionError("sync broken sliding to best")
        if not _group_next(chg, g):
            break
        if not _group_next(ochg, go):
            raise AssertionError("group sync broken advancing")


def split_lines(text: str) -> list[str]:
    """Split exactly as git (and this framework's C lexer) does: on
    ``\\n`` only — form feeds, vertical tabs, NEL, U+2028 etc. are LINE
    CONTENT; str.splitlines would break on them and shift every
    subsequent label — with no phantom empty line after a trailing
    newline. EVERY consumer that numbers source lines (label producers,
    token-line assignment, line-count filters) must use this so line
    coordinates agree end to end."""
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    return lines


def _compacted_changes(
    b: list[str],
    a: list[str],
    raw: tuple[list[bool], list[bool]] | None = None,
) -> tuple[list[bool], list[bool]]:
    """Myers + git-identical compaction of both sides; returns the two
    changed-line maps (before, after). Pass precomputed `raw` maps to
    reuse an earlier _xdl_diff (they are copied, not mutated)."""
    bchg, achg = _xdl_diff(b, a) if raw is None else (
        list(raw[0]), list(raw[1])
    )
    # git compacts xdf1 then xdf2, each against the other's current state
    _change_compact(bchg, b, achg)
    _change_compact(achg, a, bchg)
    return bchg, achg


def diff_lines(before: str, after: str) -> tuple[set[int], set[int]]:
    """(removed_lines_in_before, added_lines_in_after), 1-based."""
    b = split_lines(before)
    a = split_lines(after)
    bchg, achg = _compacted_changes(b, a)
    return (
        {i + 1 for i, c in enumerate(bchg) if c},
        {j + 1 for j, c in enumerate(achg) if c},
    )


def guarded_lines(before: str, after: str) -> set[int]:
    """Before-lines immediately following a pure insertion point.

    When a fix only *adds* lines (e.g. inserting a null/bounds check), the
    vulnerable statement is the one the insertion guards — the first
    before-line after the insertion point. This is the cheap first-order
    version of the reference's 'lines dependent on added lines' closure
    (evaluate.py:194-236); the full CPG-based dependency closure is in
    eval/statements.py.
    """
    b = split_lines(before)
    a = split_lines(after)
    raw = _xdl_diff(b, a)
    return _guards_from(b, a, raw)


def _guards_from(
    b: list[str],
    a: list[str],
    raw: tuple[list[bool], list[bool]],
    bchg: list[bool] | None = None,
) -> set[int]:
    insert_at = _insert_positions(raw[0], raw[1])
    # PURE insertions only: an insertion adjacent to a removed line is the
    # insert half of a replacement, whose label is the removed line itself.
    # Adjacency is judged against BOTH the raw Myers removed set (which is
    # where a replacement's delete half actually sits) and the compacted
    # set diff_lines reports (so a guard line can never collide with a
    # line already labeled removed — ADVICE r3).
    if bchg is None:
        bchg, _achg = _compacted_changes(b, a, raw=raw)
    removed = {i for i, c in enumerate(raw[0]) if c} | {
        i for i, c in enumerate(bchg) if c
    }
    return {
        pos + 1
        for pos in insert_at
        if pos < len(b) and pos not in removed and (pos - 1) not in removed
    }


def labeled_diff(before: str, after: str) -> tuple[set[int], set[int], set[int]]:
    """(removed_before, added_after, guarded_before), 1-based, in ONE
    Myers pass + one compaction. The single entry point for per-example
    label computation: dataset readers need removed+added (vuln filters)
    AND the labels, and Big-Vul functions run to thousands of lines."""
    b = split_lines(before)
    a = split_lines(after)
    raw = _xdl_diff(b, a)
    bchg, achg = _compacted_changes(b, a, raw=raw)
    removed = {i + 1 for i, c in enumerate(bchg) if c}
    added = {j + 1 for j, c in enumerate(achg) if c}
    guards = _guards_from(b, a, raw, bchg=bchg)
    return removed, added, guards


def vulnerable_lines(before: str, after: str) -> set[int]:
    """Line labels for the *before* version: removed/changed lines plus
    lines guarded by pure insertions."""
    removed, _added, guards = labeled_diff(before, after)
    return removed if removed else guards
