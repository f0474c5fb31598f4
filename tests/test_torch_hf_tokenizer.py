"""The port's HF tokenizer loaders against the JAX package's.

No tokenizer can be downloaded, so a Llama-convention Unigram tokenizer
is trained locally (as ``tests/test_real_tokenizer.py`` does: metaspace
``▁``, ``<unk>/<s>/</s>`` = 0/1/2) and a small BERT vocabulary is
written out.  Both packages' loaders must give the same ids, decodes,
special-token surgery, grammar surface strings and time-budget verdicts.
Without ``transformers`` the port's loaders raise an ``ImportError``
that names it, and the package itself imports without it."""

import subprocess
import sys

import numpy as np
import pytest

from mraudio_tpu.config import tiny_model_config as j_tiny
from mraudio_tpu.text import tokenizer as jtok
from mraudio_tpu_torch.config import tiny_model_config
from mraudio_tpu_torch.text import tokenizer as ttok

TEXTS = ["query video 123", " 45 ", "find the relevant windows [[12, 34], [56, 78]]",
         "a person waves at the scene 9999", "ünïcødé 7"]


@pytest.fixture(scope="module")
def tokenizer_json(tmp_path_factory):
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, processors, trainers

    corpus = tmp_path_factory.mktemp("tok") / "corpus.txt"
    rng = np.random.default_rng(0)
    words = ("query", "video", "audio", "person", "waves", "relevant", "windows", "given",
             "find", "the", "and", "a", "scene")
    lines = []
    for _ in range(2000):
        sent = " ".join(rng.choice(words, rng.integers(3, 10)))
        t0, t1 = sorted(rng.integers(0, 9999, 2))
        lines.append(f"{sent} [[{t0}, {t1}]]")
    corpus.write_text("\n".join(lines))
    tok = Tokenizer(models.Unigram())
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁")
    tok.decoder = decoders.Metaspace(replacement="▁")
    trainer = trainers.UnigramTrainer(vocab_size=256, special_tokens=["<unk>", "<s>", "</s>"],
                                      unk_token="<unk>",
                                      initial_alphabet=list("0123456789[], :.▁"))
    tok.train([str(corpus)], trainer)
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A", pair="<s> $A <s> $B", special_tokens=[("<s>", tok.token_to_id("<s>"))])
    path = str(tmp_path_factory.mktemp("tok2") / "tokenizer.json")
    tok.save(path)
    return path


def _same_behaviour(ours, theirs):
    for attr in ("vocab_size", "pad_token_id", "bos_token_id", "eos_token_id", "eos_token"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    for text in TEXTS:
        for special in (False, True):
            ids = ours.encode(text, add_special_tokens=special)
            assert ids == theirs.encode(text, add_special_tokens=special)
            for skip in (True, False):
                assert ours.decode(ids, skip) == theirs.decode(ids, skip)
    assert ours.token_strings() == theirs.token_strings()
    for side in ("left", "right"):
        a = ours(TEXTS, 6, padding_side=side, truncation_side=side, add_special_tokens=True)
        b = theirs(TEXTS, 6, padding_side=side, truncation_side=side, add_special_tokens=True)
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    assert ours.batch_decode(a.input_ids) == theirs.batch_decode(b.input_ids)


def test_llama_loader_matches_jax(tokenizer_json):
    ours = ttok.load_llama_tokenizer(tokenizer_json)
    theirs = jtok.load_llama_tokenizer(tokenizer_json)
    assert isinstance(ours, ttok.HFTokenizerWrapper)
    _same_behaviour(ours, theirs)
    # the reference's surgery: [PAD] appended, bos/eos/unk forced to </s>,
    # and the fast tokenizer's template prepending </s>
    assert ours.pad_token_id == ours.vocab_size - 1 and ours.bos_token_id == ours.eos_token_id
    assert ours.encode("video", add_special_tokens=True)[0] == ours.eos_token_id
    for max_seconds in (150, 9999):
        verdicts = []
        for mod, cfg in ((ttok, tiny_model_config()), (jtok, j_tiny())):
            tok = ours if mod is ttok else theirs
            try:
                mod.validate_time_budgets(tok, cfg, max_seconds=max_seconds)
                verdicts.append("ok")
            except ValueError as err:
                verdicts.append(str(err))
        assert verdicts[0] == verdicts[1], verdicts
        assert (ttok.required_token_budget(ours, range(0, max_seconds + 1, 37))
                == jtok.required_token_budget(theirs, range(0, max_seconds + 1, 37)))


def test_surgery_on_a_loaded_tokenizer_matches_jax(tokenizer_json):
    from transformers import PreTrainedTokenizerFast

    def raw():
        return PreTrainedTokenizerFast(tokenizer_file=tokenizer_json, bos_token="<s>",
                                       eos_token="</s>", unk_token="<unk>")

    _same_behaviour(ttok.apply_llama_surgery(raw()), jtok.apply_llama_surgery(raw()))


def test_bert_loader_matches_jax(tmp_path):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "person", "wave", "##s", "at",
             "the", "scene", "query", "video", "1", "2", "3", "4", "5", "[", "]", ","]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    ours = ttok.load_bert_tokenizer(str(tmp_path))
    theirs = jtok.load_bert_tokenizer(str(tmp_path))
    assert ours.bos_token_id == ours.tok.convert_tokens_to_ids("[DEC]")
    _same_behaviour(ours, theirs)


def test_loaders_without_transformers_name_it(tokenizer_json, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    for load in (ttok.load_llama_tokenizer, ttok.load_bert_tokenizer):
        with pytest.raises(ImportError, match="'transformers'"):
            load(tokenizer_json)


def test_package_imports_without_transformers():
    code = ("import sys\n"
            "sys.modules['transformers'] = sys.modules['tokenizers'] = None\n"
            "import mraudio_tpu_torch.text.tokenizer as t\n"
            "import mraudio_tpu_torch.cli.parity, mraudio_tpu_torch.cli.convert\n"
            "print(t.ByteTokenizer().encode('ok'))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[114, 110]", out.stderr
