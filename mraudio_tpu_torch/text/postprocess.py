"""Span-string repair and parsing for LLM moment-retrieval output.

The LLM emits the predicted moment as *text*, e.g. ``"[[12, 35]]"``.
These helpers repair near-miss outputs and parse them into window
lists, with behavior matched to the reference implementation
(``utils/utils.py:66-132`` for :func:`post_process`,
``utils/utils.py:364-415`` for :func:`moment_str_to_list`, TAL
variants at ``utils/utils.py:135-223,418-459``, percentage/relative
conversions at ``utils/utils.py:48-63,306-361``).  Every quirk of the
reference that is load-bearing for metric parity is reproduced and
called out in comments.
"""

from __future__ import annotations

import ast
import re

_NESTED_LIST_RE = re.compile(r"\[\[.*\]\]")
_SPLIT_BEFORE_BRACKET_RE = re.compile(r"\s+(?=\[)")
_TRAILING_COMMAS_RE = re.compile(r",+$")
_DIGIT_SPACE_DIGIT_RE = re.compile(r"(\d) (\d)")
_MULTI_COMMA_RE = re.compile(r",+")
_INT_RE = re.compile(r"\d+")
_NUM_RE = re.compile(r"[-+]?\d*\.\d+|\d+")


def post_process(pred: str) -> str:
    """Repair a generated window string into ``"[[a, b], [c, d]]"`` form.

    Repairs applied per window (reference parity, ``utils/utils.py:66-132``):
      * truncate at the first ``</s>`` and strip newlines,
      * reject anything not shaped like a nested list -> ``"[[-1, -1]]"``,
      * drop trailing commas, insert a missing comma between two digits
        separated by a single space, collapse comma runs,
      * swap ``t_start > t_end`` (only when the window holds exactly two
        integers; sign is ignored because the reference scans ``\\d+``).
    """
    pred = pred.split("</s>")[0]
    pred = pred.replace("\n", "").replace("\r", "")

    if not _NESTED_LIST_RE.match(pred):
        return "[[-1, -1]]"

    # Strip the outermost bracket pair, then split into per-window chunks at
    # whitespace that precedes a "[".
    inner = pred[1:-1]
    windows = _SPLIT_BEFORE_BRACKET_RE.split(inner)

    repaired = []
    for window in windows:
        window = _TRAILING_COMMAS_RE.sub("", window)
        window = _DIGIT_SPACE_DIGIT_RE.sub(r"\1, \2", window)
        window = _MULTI_COMMA_RE.sub(",", window)

        # Order repair: the reference only considers the unsigned integer
        # digit runs, and only when exactly two are present.
        numbers = _INT_RE.findall(window)
        if len(numbers) == 2:
            t_start, t_end = numbers
            if int(t_start) > int(t_end):
                window = "[" + t_end + ", " + t_start + "]"

        repaired.append(window)

    return "[" + ", ".join(repaired) + "]"


def moment_str_to_list(m: str) -> list:
    """Parse a (repaired) window string into ``[[int, int], ...]``.

    Malformed inputs map to ``[[-1, -1]]`` so that downstream IoU is 0.
    Reference-parity quirks (``utils/utils.py:364-415``), reproduced
    deliberately because eval treats them as live behavior:
      * a bare int element becomes ``[-1, -1]``,
      * a sublist whose length != 2 becomes the single-element list
        ``[-len(sublist)]``,
      * any non-int member (incl. floats) is coerced to ``-1``.
    """
    if m == "[[-1, -1]]":
        return [[-1, -1]]
    if not _NESTED_LIST_RE.match(m):
        return [[-1, -1]]

    try:
        parsed = ast.literal_eval(m)
    except (ValueError, SyntaxError, MemoryError, RecursionError):
        return [[-1, -1]]
    if not isinstance(parsed, list):
        return [[-1, -1]]

    for i in range(len(parsed)):
        if isinstance(parsed[i], int):
            parsed[i] = [-1, -1]
        if len(parsed[i]) != 2:
            parsed[i] = [-len(parsed[i])]
        for j in range(len(parsed[i])):
            if not isinstance(parsed[i][j], int):
                parsed[i][j] = -1

    return parsed


_TAL_TRAILING_COMMA_BRACKET_RE = re.compile(r",+\]")
_TAL_NUM_COMMA_NUM_WORD_RE = re.compile(r"(\d), (\d) (\w+)")
_TAL_NUM_NUM_WORD_RE = re.compile(r"(\d) (\d) (\w+)")
_WORD_RE = re.compile(r"\w+")


def post_process_tal(pred: str) -> str:
    """Repair a temporal-action-localisation triple string
    ``"[[a, b, 'label'], ...]"`` (reference ``utils/utils.py:135-223``).

    Like :func:`post_process` but windows carry a class label; windows
    without exactly two integers reject the whole string to
    ``"[[-1, -1, -1]]"``, and — matching the reference — a swap is only
    materialised when the two times are out of order.
    """
    pred = pred.split("</s>")[0]
    pred = _TAL_TRAILING_COMMA_BRACKET_RE.sub("]", pred)

    if not _NESTED_LIST_RE.match(pred):
        return "[[-1, -1, -1]]"

    inner = pred[1:-1]
    windows = _SPLIT_BEFORE_BRACKET_RE.split(inner)

    repaired = []
    for window in windows:
        window = _TRAILING_COMMAS_RE.sub("", window)
        window = _DIGIT_SPACE_DIGIT_RE.sub(r"\1, \2", window)
        window = _TAL_NUM_COMMA_NUM_WORD_RE.sub(r"\1, \2, \3", window)
        window = _TAL_NUM_NUM_WORD_RE.sub(r"\1, \2, \3", window)
        window = _MULTI_COMMA_RE.sub(",", window)

        numbers = _INT_RE.findall(window)
        labels = _WORD_RE.findall(_INT_RE.sub("", window))
        if not labels:
            labels = ['"No label"']

        if len(numbers) == 2:
            t_start, t_end = numbers
            if int(t_start) > int(t_end):
                window = "[" + t_end + ", " + t_start + ", '" + " ".join(labels) + "']"
        else:
            return "[[-1, -1, -1]]"

        repaired.append(window)

    return "[" + ", ".join(repaired) + "]"


def tal_str_to_list(m: str) -> list:
    """Parse a TAL triple string into ``[[int, int, label], ...]``
    (reference ``utils/utils.py:418-459``)."""
    if m == "[[-1, -1, -1]]":
        return [[-1, -1, -1]]
    if not _NESTED_LIST_RE.match(m):
        return [[-1, -1, -1]]

    try:
        parsed = ast.literal_eval(m)
    except (ValueError, SyntaxError, MemoryError, RecursionError):
        return [[-1, -1, -1]]
    if not isinstance(parsed, list):
        return [[-1, -1, -1]]

    for i in range(len(parsed)):
        if len(parsed[i]) != 3:
            parsed[i] = [-1, -1, -1]
    return parsed


def convert_percentages_to_second(percentages: str, duration: int) -> str:
    """Scale every number in a percentage-window string by ``duration``
    (reference ``utils/utils.py:48-63``).  Numbers that fail to convert
    become ``-1``; non-list-shaped input becomes ``"[[-1, -1]]"``."""
    if not _NESTED_LIST_RE.match(percentages):
        return "[[-1, -1]]"

    def _replace(match: re.Match) -> str:
        try:
            return str(int(float(match.group()) * duration))
        except (ValueError, OverflowError):
            return "-1"

    return _NUM_RE.sub(_replace, percentages)


def convert_to_absolute_time(
    prediction: list[str],
    duration: list[float],
    input_time_format: str,
) -> list[str]:
    """Convert relative predicted windows to absolute seconds
    (reference ``utils/utils.py:306-361``).

    ``relative_integers`` means times in 0-100; ``relative_floats`` means
    times in 0-1.  ``[-1, -1]`` windows pass through unscaled.
    """
    if input_time_format not in ("relative_integers", "relative_floats"):
        raise ValueError(
            "convert_to_absolute_time only supports relative time formats, "
            f"got {input_time_format!r}"
        )

    # Keep the exact arithmetic of the reference (x / 100 * dur, not
    # x * 0.01 * dur) so rounded outputs match bit-for-bit.
    divisor = 100.0 if input_time_format == "relative_integers" else 1.0

    parsed = [moment_str_to_list(m) for m in prediction]
    out = []
    for windows, dur in zip(parsed, duration):
        abs_windows = []
        for window in windows:
            # Reference unpacks exactly two elements; its own parser can emit
            # 1-element [-len] windows, on which it would raise.  We mirror
            # the live-path behavior (2-element windows) and skip-coerce the
            # degenerate case to [-1, -1] instead of crashing.
            if len(window) != 2:
                abs_windows.append([-1, -1])
                continue
            start, end = window
            if start != -1 and end != -1:
                abs_windows.append(
                    [round((float(start) / divisor) * dur, 2), round((float(end) / divisor) * dur, 2)]
                )
            else:
                abs_windows.append([-1, -1])
        out.append(abs_windows)

    return [str(m) for m in out]
