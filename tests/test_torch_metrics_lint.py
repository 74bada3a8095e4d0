"""The port's ``tools/metrics_lint.py`` against the reference's
``scripts/metrics_lint.py`` (loaded from its file, as
``tests/test_metrics_trace.py`` loads it): the same texts through both
``lint_text``s must give equal problem lists. The texts: both self-check
corpora (the reference's captured from its ``_self_check``, the port's
from ``self_check_texts``), every malformed case of
``tests/test_metrics_trace.py`` and more of each problem kind, and a port
``NodeMetrics`` exposition. The port's self-check and file modes exit 0 on
clean input; without a card the command names ``NoCudaDeviceError``.
"""

import importlib.util
import os
from types import SimpleNamespace

import pytest
import torch

from tendermint_tpu_torch.device import NoCudaDeviceError
from tendermint_tpu_torch.libs.critpath import PHASES
from tendermint_tpu_torch.libs.metrics import NodeMetrics
from tendermint_tpu_torch.tools import metrics_lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_reference():
    path = os.path.join(REPO, "scripts", "metrics_lint.py")
    spec = importlib.util.spec_from_file_location("ref_metrics_lint", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference()


def _reference_corpus():
    """The texts the reference's self-check lints, captured at its
    ``lint_text`` seam."""
    seen, real = [], REF.lint_text

    def record(text):
        seen.append(text)
        return real(text)

    REF.lint_text = record
    try:
        assert REF._self_check() == []
    finally:
        REF.lint_text = real
    return seen


# tests/test_metrics_trace.py's malformed cases first, then one or more of
# every other problem kind the linter names
MALFORMED = {
    "unescaped_quote": 'm{l="a"b"} 1\n',
    "duplicate_series": 'm{l="a"} 1\nm{l="a"} 2\n',
    "bad_escape": 'm{l="a\\t"} 1\n',
    "noncumulative_histogram": ("# TYPE h histogram\n"
                                'h_bucket{le="1"} 5\nh_bucket{le="2"} 3\nh_bucket{le="+Inf"} 5\n'
                                "h_sum 1\nh_count 5\n"),
    "missing_inf_bucket": "# TYPE h histogram\n" 'h_bucket{le="1"} 5\nh_sum 1\nh_count 5\n',
    "count_mismatch": '# TYPE h histogram\nh_bucket{le="+Inf"} 5\nh_sum 1\nh_count 7\n',
    "bad_value": "m not_a_number\n",
    "no_trailing_newline": "m 1",
    "bad_metric_name": "1m 1\n",
    "bad_label_name": 'm{1l="a"} 1\n',
    "label_without_equals": 'm{l"a"} 1\n',
    "unquoted_label_value": "m{l=a} 1\n",
    "unterminated_label_value": 'm{l="a} 1\n',
    "trailing_backslash_label": 'm{l="a\\',
    "duplicate_help": "# HELP m one\n# HELP m two\nm 1\n",
    "duplicate_type": "# TYPE m counter\n# TYPE m gauge\nm 1\n",
    "type_after_samples": "m 1\n# TYPE m counter\n",
    "unknown_type": "# TYPE m widget\nm 1\n",
    "type_without_kind": "# TYPE m\nm 1\n",
    "help_without_name": "# HELP\n",
    "bad_help_name": "# HELP 9m text\n",
    "illegal_help_escape": "# HELP m bad \\t escape\nm 1\n",
    "trailing_backslash_help": "# HELP m text\\\nm 1\n",
    "missing_value": "m\n",
    "bad_timestamp": "m 1 soon\n",
    "trailing_garbage": "m 1 2 3\n",
    "bucket_without_le": '# TYPE h histogram\nh_bucket{x="1"} 5\nh_bucket{le="+Inf"} 5\n',
    "bad_le": '# TYPE h histogram\nh_bucket{le="x"} 5\nh_bucket{le="+Inf"} 5\n',
    "several_problems": ('# TYPE h histogram\nh_bucket{le="1"} 5\nh_bucket{le="1"} 5\n'
                         'm{l="a\\q"} 1\nm2 NaN 12\nm3 +Inf\n'),
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_problem_lists_equal(name):
    text = MALFORMED[name]
    want = REF.lint_text(text)
    assert want, f"the reference finds no problem in case {name}"
    assert metrics_lint.lint_text(text) == want


def test_reference_self_check_corpus_lints_equal():
    corpus = _reference_corpus()
    assert len(corpus) == 6
    for text in corpus:
        assert metrics_lint.lint_text(text) == REF.lint_text(text) == []


def test_port_self_check_corpus_lints_equal():
    failures, texts = metrics_lint.self_check_texts()
    assert failures == []
    assert [label for label, _ in texts] == [
        "escaping registry", "VerifyMetrics", "FrontendMetrics", "VoteBatchMetrics",
        "MempoolBatchMetrics", "NodeMetrics(+verify attached)"]
    for _, text in texts:
        assert metrics_lint.lint_text(text) == REF.lint_text(text) == []
    assert metrics_lint.self_check() == []


def test_escaping_corpus_is_not_trivial():
    """The escaping registry's text carries every escape the linter
    unescapes, and a flipped escape in it is caught by both."""
    _, texts = metrics_lint.self_check_texts()
    text = dict(texts)["escaping registry"]
    for needle in ('\\"', "\\n", "\\\\"):
        assert needle in text
    broken = text.replace('\\"', '"', 1)
    assert metrics_lint.lint_text(broken) == REF.lint_text(broken) != []


def _block(height: int, n_missing: int):
    """A block as ``NodeMetrics.record_block`` reads one (the fields of
    ``tests/test_metrics_trace.py``'s ``_FakeBlock``)."""
    return SimpleNamespace(
        height=height, data=SimpleNamespace(txs=[b"t1", b"t2"]),
        evidence=SimpleNamespace(evidence=[]),
        last_commit=SimpleNamespace(precommits=[None] * n_missing + ["sig"] * (3 - n_missing)),
        marshal=lambda: b"x" * 100)


def test_port_node_metrics_exposition_lints_equal():
    m = NodeMetrics()
    m.record_peer_traffic("ab" * 20, 0x40, sent=100, received=50)
    m.record_vote_sighting("ab" * 20, 0x22, first=True)
    m.record_vote_sighting("ab" * 20, 0x22, first=False)
    for i, phase in enumerate(PHASES):
        m.height_phase_seconds.observe(0.002 * (i + 1), (phase,))
    m.step_duration.observe(0.01, ("PREVOTE",))
    m.quorum_time_to_two_thirds.observe(0.05, ("precommit",))
    valset = SimpleNamespace(size=3, total_voting_power=lambda: 30)
    m.record_block(_block(2, 1), valset)
    m.record_block(_block(3, 0), valset)
    text = m.registry.expose_text()
    assert "tendermint_consensus_height_phase_seconds_bucket" in text
    assert "tendermint_consensus_block_interval_seconds_count 1" in text
    assert metrics_lint.lint_text(text) == REF.lint_text(text) == []


def test_main_self_check_and_file_modes(tmp_path, capsys):
    assert metrics_lint.main(["--device", "cpu"]) == 0
    assert "self-check: OK" in capsys.readouterr().out
    good, bad = tmp_path / "good.txt", tmp_path / "bad.txt"
    good.write_text(NodeMetrics().registry.expose_text())
    bad.write_text(MALFORMED["duplicate_series"])
    assert metrics_lint.main(["--device", "cpu", str(good)]) == 0
    assert metrics_lint.main(["--device", "cpu", str(good), str(bad)]) == 1
    err = capsys.readouterr().err
    assert "duplicate series" in err and str(bad) in err


def test_main_without_a_card_names_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(NoCudaDeviceError):
        metrics_lint.main([])
