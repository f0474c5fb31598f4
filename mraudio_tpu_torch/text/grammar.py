"""Span-grammar tables for constrained and speculative decoding.

The port's own copy of the JAX package's ``text/grammar.py`` (numpy
only).  The output format is ``[[start, end], [start, end], ...]``; a
character DFA of that grammar is simulated over every token's surface
string to give the token-level tables ``infer/generate.py::
grammar_generate`` reads:

* ``allowed[s, t]``    — token ``t`` may be emitted in DFA state ``s``;
* ``next_state[s, t]`` — the state after emitting it;
* ``forced[s]``        — the single allowed token id in ``s`` (or -1);
* ``dist_next[s, t]``  — the fewest further tokens that finish the
  grammar after emitting ``t`` in ``s`` (a large sentinel where ``t`` is
  not allowed).

Any tokenizer with ``token_strings()`` (specials map to "") compiles;
a multi-character token is allowed exactly where its characters would be
in turn.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# The character DFA encodes, with NUM = (0|[1-9]\d{0,max_digits-1})
# (\.\d{1,max_digits})? (the fraction only with allow_float):
#   " *\[\[NUM, NUM\](, \[NUM, NUM\])*\]" EOS
# i.e. what str([[a, b], ...]) prints for int or float windows, after
# optional spaces.  No leading zeros (ast.literal_eval rejects them) and
# digit runs of at most max_digits (a weak model cannot spend the whole
# budget on one number).

_DIGITS = "0123456789"

START = 0        # optional spaces, then '['


def _char_transitions(allow_float: bool, max_digits: int = 6) -> tuple[list[dict], int, int]:
    """The character DFA: (transitions, TERMINAL, DONE).  State 0 is
    START; TERMINAL admits only EOS; DONE is absorbing."""
    trans: list[dict] = []

    def new_state() -> int:
        trans.append({})
        return len(trans) - 1

    start = new_state()
    lb1 = new_state()
    trans[start][" "] = start
    trans[start]["["] = lb1

    def build_number(entry: int, terminators: dict) -> None:
        """NUM transitions out of ``entry``; each terminator character
        leads to its successor state."""
        zero = new_state()                     # a bare '0'
        trans[entry]["0"] = zero
        trans[zero].update(terminators)
        cur = None
        for i in range(max_digits):
            nxt = new_state()
            for d in (_DIGITS[1:] if i == 0 else _DIGITS):
                trans[entry if i == 0 else cur][d] = nxt
            trans[nxt].update(terminators)
            cur = nxt
        if allow_float:
            frac0 = new_state()                # after '.', at least one digit
            trans[zero]["."] = frac0
            for s in range(frac0 - max_digits, frac0):   # every integer-digit state
                trans[s]["."] = frac0
            fcur = frac0
            for _ in range(max_digits):
                fnxt = new_state()
                for d in _DIGITS:
                    trans[fcur][d] = fnxt
                trans[fnxt].update(terminators)
                fcur = fnxt

    w_start = new_state()                      # a window's '[': "[[" and ", ["
    trans[lb1]["["] = w_start
    comma1 = new_state()
    w_end = new_state()
    trans[comma1][" "] = w_end
    w_close = new_state()
    sep = new_state()
    next_w = new_state()
    terminal = new_state()
    done = new_state()
    trans[w_close][","] = sep
    trans[w_close]["]"] = terminal
    trans[sep][" "] = next_w
    trans[next_w]["["] = w_start
    build_number(w_start, {",": comma1})
    build_number(w_end, {"]": w_close})
    return trans, terminal, done


def char_accepts(text: str, allow_float: bool = True, max_digits: int = 6) -> bool:
    """True iff ``text`` is a complete span string under the DFA."""
    trans, terminal, _ = _char_transitions(allow_float, max_digits)
    state = START
    for ch in text:
        state = trans[state].get(ch, -1)
        if state < 0:
            return False
    return state == terminal


@dataclass(frozen=True)
class GrammarTables:
    """Token-level DFA tables (numpy)."""

    allowed: np.ndarray       # (num_states, vocab) bool
    next_state: np.ndarray    # (num_states, vocab) int32
    forced: np.ndarray        # (num_states,) int32; -1 = free choice
    dist_next: np.ndarray     # (num_states, vocab) int32
    eos_id: int
    terminal_state: int       # list closed; only EOS allowed
    done_state: int           # absorbing post-EOS state
    start_state: int = START


def compile_grammar(tokenizer, allow_float: bool = True, max_digits: int = 6) -> GrammarTables:
    """Compile the span grammar against ``tokenizer``'s vocabulary: a
    (state, token) pair is allowed iff every character of the token's
    string has a transition.  EOS is allowed exactly in the terminal and
    the done state."""
    if not hasattr(tokenizer, "token_strings"):
        raise TypeError(f"tokenizer {type(tokenizer).__name__} does not expose token_strings()")
    strings = tokenizer.token_strings()
    vocab = len(strings)
    eos_id = int(tokenizer.eos_token_id)
    trans, terminal, done = _char_transitions(allow_float, max_digits)
    num_states = len(trans)

    allowed = np.zeros((num_states, vocab), dtype=bool)
    next_state = np.zeros((num_states, vocab), dtype=np.int32)
    by_string: dict[str, list[int]] = {}
    for tid, s in enumerate(strings):
        if s:
            by_string.setdefault(s, []).append(tid)
    for s_str, tids in by_string.items():
        for state in range(num_states):
            cur = state
            for ch in s_str:
                cur = trans[cur].get(ch, -1)
                if cur < 0:
                    break
            if cur >= 0:
                allowed[state, tids] = True
                next_state[state, tids] = cur

    allowed[terminal, :] = False
    allowed[done, :] = False
    allowed[terminal, eos_id] = True
    allowed[done, eos_id] = True
    next_state[terminal, eos_id] = done
    next_state[done, eos_id] = done

    counts = allowed.sum(axis=1)
    if not counts.all():
        raise ValueError(f"grammar states {np.nonzero(counts == 0)[0].tolist()} admit no token "
                         "under this vocabulary: the tokenizer cannot spell the span format")
    forced = np.where(counts == 1, allowed.argmax(axis=1), -1).astype(np.int32)

    # fewest tokens from each state to DONE, EOS included (value
    # iteration over the token graph); a forced token is always
    # budget-safe, since dist(s) = 1 + dist(next) there
    inf = 1 << 30
    dist = np.full(num_states, inf, dtype=np.int64)
    dist[done] = 0
    for _ in range(num_states + 1):
        cand = np.where(allowed, 1 + np.minimum(dist, inf - 1)[next_state], inf)
        new = np.minimum(dist, cand.min(axis=1))
        new[done] = 0
        if (new == dist).all():
            break
        dist = new
    if (dist >= inf).any():
        raise ValueError(f"grammar states {np.nonzero(dist >= inf)[0].tolist()} cannot reach "
                         "completion")
    dist_next = np.where(allowed, dist[next_state], inf).astype(np.int32)

    return GrammarTables(allowed=allowed, next_state=next_state, forced=forced,
                         dist_next=dist_next, eos_id=eos_id, terminal_state=terminal,
                         done_state=done)
