"""Tokenizer protocol + implementations.

The reference uses two tokenizers: HF ``LlamaTokenizer`` with pad/bos/
eos/unk all forced to ``</s>``/``[PAD]`` (``models/xinstructblip.py:
140-144``) for the LLM, and ``BertTokenizer`` (+``[DEC]`` bos) for the
Q-Former (``:609-612``).  Both need weight files; with no network and no
checkpoint corpus, tests and benchmarks run on :class:`ByteTokenizer`
— a deterministic byte-level fallback that reproduces the structural
behavior (special-token ids, padding sides, truncation sides) without
vocabulary files.  When real assets exist on a local path,
:func:`load_llama_tokenizer` and :func:`load_bert_tokenizer` wrap the HF
tokenizers with the reference's surgery (:class:`HFTokenizerWrapper`).
They need ``transformers`` (and ``tokenizers`` for a fast tokenizer),
imported when called, so the package imports without them.

All batched encodes here produce **fixed-length** arrays (static device
shapes); "longest" padding from the reference becomes masked positions,
which the position-id convention (cumsum of the mask) makes equivalent.
"""

from __future__ import annotations

import numpy as np


class BatchEncoding(dict):
    @property
    def input_ids(self) -> np.ndarray:
        return self["input_ids"]

    @property
    def attention_mask(self) -> np.ndarray:
        return self["attention_mask"]

    @property
    def lengths(self) -> np.ndarray:
        """Raw (pre-truncation) sequence lengths: lets callers detect
        silent truncation against their static budget."""
        return self["lengths"]

    @property
    def num_truncated(self) -> int:
        return int((self.lengths > self.input_ids.shape[1]).sum())


def _pad_batch(
    seqs: list[list[int]],
    max_len: int,
    pad_id: int,
    padding_side: str,
    truncation_side: str,
) -> BatchEncoding:
    ids = np.full((len(seqs), max_len), pad_id, dtype=np.int32)
    mask = np.zeros((len(seqs), max_len), dtype=np.int32)
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    for i, seq in enumerate(seqs):
        if len(seq) > max_len:
            seq = seq[-max_len:] if truncation_side == "left" else seq[:max_len]
        n = len(seq)
        if padding_side == "left":
            ids[i, max_len - n :] = seq
            mask[i, max_len - n :] = 1
        else:
            ids[i, :n] = seq
            mask[i, :n] = 1
    return BatchEncoding(input_ids=ids, attention_mask=mask, lengths=lengths)


class ByteTokenizer:
    """Byte-level tokenizer with Llama-compatible special-token layout.

    ids 0..2 mirror Llama (<unk>/unused, <s>, </s>); byte b maps to
    ``3 + b``; the appended ``[PAD]`` takes the final id — mirroring the
    reference's ``add_special_tokens({'pad_token': '[PAD]'})`` growing the
    vocab by one (``models/xinstructblip.py:141,154``).  bos/eos/unk are
    all ``</s>`` (id 2), as the reference forces.
    """

    def __init__(self, vocab_size: int = 260):
        assert vocab_size >= 260, "need 3 specials + 256 bytes + [PAD]"
        self.vocab_size = vocab_size
        self.pad_token_id = vocab_size - 1
        self.bos_token_id = 2
        self.eos_token_id = 2
        self.unk_token_id = 2
        self.eos_token = "</s>"

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        ids = [3 + b for b in text.encode("utf-8")]
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        data = bytearray()
        for t in np.asarray(ids).tolist():
            if 3 <= t < 259:
                data.append(t - 3)
            elif not skip_special_tokens:
                if t == 2:
                    data.extend(b"</s>")
        return data.decode("utf-8", errors="ignore")

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> list[str]:
        return [self.decode(row, skip_special_tokens) for row in np.asarray(batch)]

    def token_strings(self) -> list[str]:
        """Per-id surface strings (specials -> "") for grammar compilation
        (text/grammar.py)."""
        out = [""] * self.vocab_size
        for b in range(256):
            out[3 + b] = chr(b)
        out[self.pad_token_id] = ""
        return out

    def __call__(
        self,
        texts: list[str],
        max_length: int,
        padding_side: str = "right",
        truncation_side: str = "right",
        add_special_tokens: bool = False,
    ) -> BatchEncoding:
        seqs = [self.encode(t, add_special_tokens) for t in texts]
        return _pad_batch(seqs, max_length, self.pad_token_id, padding_side, truncation_side)



def required_token_budget(tokenizer, values, template: str = " {} ") -> int:
    """Max token count of ``template.format(v)`` over ``values`` for any
    tokenizer implementing the protocol: what the static
    ``tokens_per_timestamp`` / ``tokens_per_duration`` budgets must hold."""
    return max(
        len(tokenizer.encode(template.format(v), add_special_tokens=False))
        for v in values
    )


def validate_time_budgets(tokenizer, cfg, max_seconds: int = 10_000) -> None:
    """Raise if any timestamp/duration rendering in [0, max_seconds]
    would overflow the model config's static budgets.  Sweeps the worst
    cases per digit count rather than every integer."""
    probes = [0, 1, 7, 9]
    v = 9
    while v <= max_seconds:
        probes.extend([v, min(v + 1, max_seconds)])
        v = v * 10 + 9
    probes.append(max_seconds)
    need_ts = required_token_budget(tokenizer, probes, " {} ")
    need_dur = required_token_budget(tokenizer, probes, "{} ")
    errors = []
    if need_ts > cfg.tokens_per_timestamp:
        errors.append(
            f"tokens_per_timestamp={cfg.tokens_per_timestamp} < required "
            f"{need_ts} for values up to {max_seconds}s"
        )
    if need_dur > cfg.tokens_per_duration:
        errors.append(
            f"tokens_per_duration={cfg.tokens_per_duration} < required "
            f"{need_dur} for values up to {max_seconds}s"
        )
    if errors:
        raise ValueError("; ".join(errors))


class HFTokenizerWrapper:
    """Adapts a HF tokenizer to the fixed-length protocol above."""

    def __init__(self, tok):
        self.tok = tok
        self.pad_token_id = tok.pad_token_id
        self.bos_token_id = tok.bos_token_id
        self.eos_token_id = tok.eos_token_id
        self.eos_token = tok.eos_token
        self.vocab_size = len(tok)

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        return self.tok.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self.tok.decode(np.asarray(ids).tolist(), skip_special_tokens=skip_special_tokens)

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> list[str]:
        return [self.decode(row, skip_special_tokens) for row in np.asarray(batch)]

    def token_strings(self) -> list[str]:
        """Per-id surface strings for grammar compilation
        (text/grammar.py): sentencepiece "▁"/byte-level "Ġ" markers become
        spaces, "<0xNN>" byte-fallback pieces become their character, and
        every special id maps to "" (EOS is wired explicitly by the
        grammar compiler)."""
        pieces = self.tok.convert_ids_to_tokens(list(range(self.vocab_size)))
        special = set(getattr(self.tok, "all_special_ids", []) or [])
        special |= {i for i in (self.pad_token_id, self.bos_token_id, self.eos_token_id)
                    if i is not None}
        out = []
        for tid, piece in enumerate(pieces):
            if piece is None or tid in special:
                out.append("")
                continue
            if len(piece) == 6 and piece.startswith("<0x") and piece.endswith(">"):
                try:
                    out.append(chr(int(piece[3:5], 16)))
                    continue
                except ValueError:
                    pass
            out.append(piece.replace("▁", " ").replace("Ġ", " "))
        return out

    def __call__(self, texts, max_length, padding_side="right", truncation_side="right",
                 add_special_tokens=False) -> BatchEncoding:
        seqs = [self.encode(t, add_special_tokens) for t in texts]
        return _pad_batch(seqs, max_length, self.pad_token_id, padding_side, truncation_side)


def _require(package: str):
    """``import package``, or an ``ImportError`` that names it."""
    import importlib

    try:
        return importlib.import_module(package)
    except ImportError as err:
        raise ImportError(f"the HF tokenizer loaders need the {package!r} package, which is "
                          "not installed; ByteTokenizer needs nothing") from err


def apply_llama_surgery(tok) -> HFTokenizerWrapper:
    """The reference's special-token surgery on any HF llama-family
    tokenizer (``models/xinstructblip.py:140-144``): append ``[PAD]``
    (growing the vocab by one, ``:154``) and force bos/eos/unk to
    ``</s>``."""
    tok.add_special_tokens({"pad_token": "[PAD]"})
    tok.add_special_tokens({"bos_token": "</s>"})
    tok.add_special_tokens({"eos_token": "</s>"})
    tok.add_special_tokens({"unk_token": "</s>"})
    if getattr(tok, "is_fast", False):
        # A fast tokenizer bakes its BOS template into the backend; the
        # reference's slow LlamaTokenizer re-derives specials from
        # self.bos_token, so after the remap it prepends </s>.  Rewrite
        # the template to reproduce that.
        processors = _require("tokenizers").processors
        tok._tokenizer.post_processor = processors.TemplateProcessing(
            single="</s> $A",
            pair="</s> $A </s> $B",
            special_tokens=[("</s>", tok.convert_tokens_to_ids("</s>"))],
        )
    return HFTokenizerWrapper(tok)


def load_llama_tokenizer(path: str) -> HFTokenizerWrapper:
    """HF LlamaTokenizer with the reference's special-token surgery, from
    a local path: a sentencepiece-backed directory (slow tokenizer) or a
    ``tokenizer.json`` (fast).  Nothing is fetched from the network."""
    transformers = _require("transformers")
    if path.endswith(".json"):
        tok = transformers.PreTrainedTokenizerFast(
            tokenizer_file=path, bos_token="<s>", eos_token="</s>",
            unk_token="<unk>", truncation_side="left",
        )
    else:
        tok = transformers.LlamaTokenizer.from_pretrained(
            path, use_fast=False, truncation_side="left", local_files_only=True)
    return apply_llama_surgery(tok)


def load_bert_tokenizer(path: str) -> HFTokenizerWrapper:
    """BERT tokenizer with the [DEC] bos token
    (``models/xinstructblip.py:609-612``), from a local directory (the
    JAX package's default names the hub's ``bert-base-uncased``; nothing
    is fetched here)."""
    tok = _require("transformers").BertTokenizer.from_pretrained(
        path, truncation_side="left", local_files_only=True)
    tok.add_special_tokens({"bos_token": "[DEC]"})
    return HFTokenizerWrapper(tok)
