"""The port's numpy-only data pipeline against the reference's: the same
(seed, step, host) gives the same batch, bit for bit; the reference's
`TestDataPipeline` cases on the port."""
import dataclasses

import numpy as np
import pytest

from repro.data import pipeline as JP
from repro_torch.data import pipeline as TP


@pytest.mark.parametrize("vocab,seq,batch,seed,hosts", [
    (128, 32, 8, 0, 1), (1000, 17, 6, 3, 2), (64000, 64, 4, 11, 4),
    (256, 64, 2, 5, 1)])
def test_batches_bit_equal_to_reference(vocab, seq, batch, seed, hosts):
    cfg = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    for host in range(hosts):
        t = TP.SyntheticTokens(TP.DataConfig(**cfg), host, hosts)
        j = JP.SyntheticTokens(JP.DataConfig(**cfg), host, hosts)
        np.testing.assert_array_equal(t.next_tok, j.next_tok)
        for step in (0, 1, 17, 1000):
            a, b = t.batch(step), j.batch(step)
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_config_fields_and_entropy_equal_reference():
    assert [f.name for f in dataclasses.fields(TP.DataConfig)] == \
        [f.name for f in dataclasses.fields(JP.DataConfig)]
    for vocab in (64, 64000):
        c = dict(vocab=vocab, seq_len=8, global_batch=2)
        assert TP.unigram_entropy(TP.DataConfig(**c)) == \
            JP.unigram_entropy(JP.DataConfig(**c))


def test_iteration_follows_steps():
    src = TP.SyntheticTokens(TP.DataConfig(vocab=50, seq_len=8,
                                           global_batch=2))
    it = iter(src)
    for step in range(3):
        np.testing.assert_array_equal(next(it), src.batch(step))


def test_deterministic_in_step_and_host():
    cfg = TP.DataConfig(vocab=128, seq_len=32, global_batch=8)
    a = TP.SyntheticTokens(cfg, host_id=0, num_hosts=2)
    b = TP.SyntheticTokens(cfg, host_id=0, num_hosts=2)
    np.testing.assert_array_equal(a.batch(17), b.batch(17))
    c = TP.SyntheticTokens(cfg, host_id=1, num_hosts=2)
    assert not np.array_equal(a.batch(17), c.batch(17))
    assert a.batch(17).shape == (4, 32)


def test_resume_mid_stream():
    cfg = TP.DataConfig(vocab=128, seq_len=16, global_batch=4)
    src = TP.SyntheticTokens(cfg)
    direct = src.batch(42)
    pf = TP.Prefetcher(src, start_step=42)
    step, fetched = pf.next()
    step2, fetched2 = pf.next()
    pf.close()
    assert (step, step2) == (42, 43)
    np.testing.assert_array_equal(direct, fetched)
    np.testing.assert_array_equal(src.batch(43), fetched2)


def test_token_range():
    b = TP.SyntheticTokens(TP.DataConfig(vocab=100, seq_len=64,
                                         global_batch=4)).batch(0)
    assert b.min() >= 0 and b.max() < 100


def test_structure_learnable():
    """Bigram structure exists: successor entropy < unigram entropy."""
    b = TP.SyntheticTokens(TP.DataConfig(vocab=64, seq_len=256,
                                         global_batch=16)).batch(0)
    pairs = {}
    for row in b:
        for x, y in zip(row[:-1], row[1:]):
            pairs.setdefault(int(x), []).append(int(y))
    hits = tot = 0
    for ys in pairs.values():
        _, counts = np.unique(ys, return_counts=True)
        hits += counts.max()
        tot += counts.sum()
    assert hits / tot > 0.2, hits / tot


def test_hosts_must_divide_the_batch():
    with pytest.raises(AssertionError):
        TP.SyntheticTokens(TP.DataConfig(vocab=10, seq_len=4,
                                         global_batch=3), 0, 2)
