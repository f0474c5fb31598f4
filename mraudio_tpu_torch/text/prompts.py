"""Prompt construction for moment retrieval.

The live prompt of the reference is the short two-line query+task string
(``utils/mr_dataset.py:95-99``).  The elaborate few-shot prompt built
just above it (``:57-93``) is dead code there (immediately overwritten);
its *surface* — a tagged few-shot prompt with relative-percentage window
examples and format instructions — is re-provided here as the opt-in
``prompt_style="fewshot"`` (own wording: the reference string is an
abandoned experiment, so structural equivalence, not byte parity, is the
contract; pair it with ``time_format="relative_floats"`` as its window
examples imply).

Timestamp prompt formats mirror the five experiment variants of
``utils/utils.py:462-603`` but operate on plain Python floats instead of
torch tensors (timestamps are host-side metadata here; the device only
ever sees their token embeddings).
"""

from __future__ import annotations

from typing import Mapping, Sequence

TASK_PROMPT = (
    "Given the video and the query, find the relevant windows.\nRelevant windows: "
)

# Cue strings announcing each modality segment in the interleaved LLM input
# (reference ``models/xinstructblip.py:206-209``).
MODALITY_CUES = {
    "video": " video: ",
    "audio": " audio: ",
}

TIME_FORMATS = (
    "seconds_integers",
    "relative_integers",
    "seconds_floats",
    "relative_floats",
    "framenumbers",
)


def build_query_prompt(query: str) -> str:
    """The live eval/train prompt: ``Query: <q>\\n<task>`` (reference
    ``utils/mr_dataset.py:97-99``)."""
    return "Query: " + query + "\n" + TASK_PROMPT


# Few-shot examples for prompt_style="fewshot": windows as fractions of
# the video duration, mirroring the shape of the reference's abandoned
# examples (single window, multi-window, near-full-span).
FEWSHOT_EXAMPLES = (
    ("a chef plates the finished dish and wipes the rim",
     150, "[[0.62, 0.71]]"),
    ("the dog runs to fetch the ball and brings it back",
     150, "[[0.05, 0.12], [0.40, 0.49]]"),
    ("a crowd slowly fills the stadium before the match",
     150, "[[0.18, 0.97]]"),
)

FEWSHOT_FORMAT = (
    "[[x, y], [a, b]] — each window is a pair of fractions of the video "
    "duration in [0, 1]; use a single pair [[x, y]] when one window "
    "suffices; keep windows ascending and non-overlapping."
)


def build_fewshot_prompt(query: str, duration: float) -> str:
    """Opt-in few-shot prompt (the reference's dead experimental surface,
    ``utils/mr_dataset.py:57-93``): tagged query/duration, worked
    examples with relative windows, and explicit format rules."""
    examples = "\n".join(
        f"query: <Query> {q} </Query>\n"
        f"duration: <Duration> {d} </Duration>\n"
        f"relevant_windows: {w}\n"
        for q, d, w in FEWSHOT_EXAMPLES
    )
    return (
        "Follow the examples and format exactly.\n"
        f"Examples: <Example>\n{examples}</Example>\n"
        f"Format: <Format> {FEWSHOT_FORMAT} </Format>\n"
        f"Query: <Query> {query} </Query>\n"
        f"Duration: <Duration> {round(duration)} </Duration>\n"
        "Give the relevant windows matching the query for the given "
        "duration.\nrelevant_windows: "
    )


def build_prompt(style: str, query: str, duration: float) -> str:
    if style == "fewshot":
        return build_fewshot_prompt(query, duration)
    if style == "live" or not style:
        return build_query_prompt(query)
    raise ValueError(f"unknown prompt_style {style!r}; expected live|fewshot")


def _sub_annoying(value: int, replacements: Mapping[int, int] | None) -> int:
    if replacements and value in replacements:
        return replacements[value]
    return value


def format_timestamp_prompt(
    timestamps: Sequence[float],
    duration: float,
    time_format: str = "seconds_integers",
    annoying_numbers_replacement: Mapping[int, int] | None = None,
) -> tuple[list[float], float, str]:
    """Render per-frame timestamps + duration into the ``>``-joined video
    prompt string of the reference's timestamp-format experiments.

    Returns ``(timestamps, duration, video_prompt)`` for a single sample;
    shapes follow ``utils/utils.py:462-603`` per format:

    - ``seconds_integers``  (ref ``:462-508``): ints, ``>t0>t1>...>dur``
      with a leading ``>``; "annoying" token-splitting numbers replaced.
    - ``relative_integers`` (ref ``:511-535``): 0-100 ints, ``t0>...>dur``.
    - ``seconds_floats``    (ref ``:538-558``): 2-decimal floats.
    - ``relative_floats``   (ref ``:561-586``): 0-1 floats; the final
      timestamp slot carries the rounded duration.
    - ``framenumbers``      (ref ``:589-603``): 0..n-1 indices.
    """
    if time_format not in TIME_FORMATS:
        raise ValueError(f"unknown time_format {time_format!r}; expected one of {TIME_FORMATS}")

    if time_format == "seconds_integers":
        vals = [_sub_annoying(int(round(t)), annoying_numbers_replacement) for t in timestamps]
        dur = _sub_annoying(int(round(duration)), annoying_numbers_replacement)
        prompt = ">" + ">".join(str(v) for v in vals) + ">" + str(dur)
        return [float(v) for v in vals], float(dur), prompt

    if time_format == "relative_integers":
        vals = [int(round(t / duration, 2) * 100) for t in timestamps]
        prompt = ">".join(str(v) for v in vals) + ">" + str(round(duration))
        return [float(v) for v in vals], float(duration), prompt

    if time_format == "seconds_floats":
        vals = [round(float(t), 2) for t in timestamps]
        prompt = ">".join(str(v) for v in vals) + ">" + str(round(duration))
        return vals, float(duration), prompt

    if time_format == "relative_floats":
        vals = [round(t / duration, 2) for t in timestamps]
        prompt = ">".join(str(v) for v in vals[:-1]) + ">" + str(round(duration))
        return vals[:-1] + [float(round(duration))], float(duration), prompt

    # framenumbers
    vals = list(range(len(timestamps)))
    prompt = ">".join(str(i) for i in vals) + ">" + str(duration)
    return [float(v) for v in vals], float(duration), prompt
