"""Regex -> token-DFA compiler: the automaton must admit exactly the
token sequences whose concatenated spellings can extend to a full regex
match (Python `re` is the oracle), and it must drive the engine to
regex-valid generations end to end.
"""

import re

import jax
import numpy as np
import pytest

from flash_attention_cute.models import init_params
from flash_attention_cute.models.config import tiny_test_config
from flash_attention_cute.runtime.dfa_compile import compile_regex_dfa
from flash_attention_cute.runtime.engine import ServingEngine


def _enumerate(dfa, vocab, max_len, eos=None):
    """All token sequences the automaton permits, up to max_len, tagged
    with whether they END at EOS (a complete match)."""
    out = []

    def rec(state, seq):
        if len(seq) >= max_len:
            return
        for tok in range(len(vocab)):
            if not np.isfinite(dfa["bias"][state, tok]):
                continue
            if eos is not None and tok == eos:
                out.append((seq, True))
                continue
            nxt = int(dfa["transitions"][state, tok])
            out.append((seq + [tok], False))
            rec(nxt, seq + [tok])

    rec(dfa["start"], [])
    return out


@pytest.mark.parametrize("pattern", [
    "(ab)+c",
    "[ab]*c(d|e)?",
    "x[0-9]+(\\.[0-9]+)?",
])
def test_compiled_dfa_matches_re_oracle(pattern):
    vocab = ["a", "b", "c", "d", "e", "x", ".", "0", "1", "9",
             "ab", "cd", "12", "<eos>"]
    eos = len(vocab) - 1
    dfa = compile_regex_dfa(pattern, vocab, eos_token_id=eos)
    seqs = _enumerate(dfa, vocab, max_len=4, eos=eos)
    assert seqs, pattern
    rx = re.compile(pattern)
    complete = 0
    for seq, is_complete in seqs:
        text = "".join(vocab[t] for t in seq)
        if is_complete:
            complete += 1
            assert rx.fullmatch(text), (pattern, text)
        else:
            # Every permitted prefix must extend to SOME full match using
            # the available vocabulary (coaccessibility pruning).
            assert any(
                rx.fullmatch(text + "".join(vocab[t] for t in ext))
                for ext, done in _enumerate_from(dfa, vocab, seq, eos)
                if done
            ) or _reaches_accept(dfa, vocab, seq, eos), (pattern, text)
    assert complete > 0, pattern


def _walk(dfa, seq):
    s = dfa["start"]
    for t in seq:
        s = int(dfa["transitions"][s, t])
    return s


def _reaches_accept(dfa, vocab, seq, eos, depth=6):
    state = _walk(dfa, seq)
    frontier = {state}
    for _ in range(depth):
        if any(bool(dfa["accepting"][s]) for s in frontier):
            return True
        nxt = set()
        for s in frontier:
            for tok in range(len(vocab)):
                if tok != eos and np.isfinite(dfa["bias"][s, tok]):
                    nxt.add(int(dfa["transitions"][s, tok]))
        frontier = nxt
    return False


def _enumerate_from(dfa, vocab, seq, eos):
    sub = {**dfa, "start": _walk(dfa, seq)}
    return _enumerate(sub, vocab, max_len=3, eos=eos)


def test_known_positive_walks():
    vocab = ["a", "b", "c", "ab", "<eos>"]
    dfa = compile_regex_dfa("(ab)+c", vocab, eos_token_id=4)
    # "ab" "ab" "c" <eos> and "a" "b" "c" <eos> both valid.
    for seq in ([3, 3, 2], [0, 1, 2], [3, 0, 1, 2]):
        s = dfa["start"]
        for t in seq:
            assert np.isfinite(dfa["bias"][s, t]), (seq, t)
            s = int(dfa["transitions"][s, t])
        assert bool(dfa["accepting"][s])
        assert np.isfinite(dfa["bias"][s, 4])  # EOS allowed
    # "b" first is banned; "c" straight away banned; eos at start banned.
    assert not np.isfinite(dfa["bias"][dfa["start"], 1])
    assert not np.isfinite(dfa["bias"][dfa["start"], 2])
    assert not np.isfinite(dfa["bias"][dfa["start"], 4])


def test_engine_generates_regex_valid_text():
    """End to end: a tiny model constrained by a compiled regex DFA emits
    token streams whose spellings match the pattern when EOS fires, and
    a valid prefix otherwise."""
    cfg = tiny_test_config(num_layers=2, vocab_size=8)
    params = init_params(cfg, jax.random.key(0))
    vocab = ["a", "b", "c", "ab", "x", "0", "1", "<eos>"]
    eos = 7
    pattern = "(ab)+c"
    dfa = compile_regex_dfa(pattern, vocab, eos_token_id=eos)

    eng = ServingEngine(
        params, cfg, slots=1, num_pages=17, page_size=8, pages_per_seq=8,
        interpret=True, dfa=dfa, eos_token_id=eos,
    )
    eng.submit(0, [4, 5, 6], 10, constrain=True)
    out = eng.run()[0]
    text = "".join(vocab[t] for t in out if t != eos)
    if out and out[-1] == eos:
        assert re.fullmatch(pattern, text), (out, text)
    else:
        # Budget ended mid-match: the prefix must still be extendable.
        assert _reaches_accept(dfa, vocab, out, eos), (out, text)
