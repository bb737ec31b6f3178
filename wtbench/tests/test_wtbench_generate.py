"""The traffic generator and the speech generator: deterministic per seed,
the corpus stretches' lengths and (T, F) keys as the configurations state."""

import numpy as np

from wtbench import generate as G, harness as Hn, speech

SEED = 2**31 + 977


def test_utterances_deterministic_per_seed():
    lengths = [2205, 3000, 4410]
    a = speech.utterances(22050, lengths, SEED, "cpu")
    b = speech.utterances(22050, lengths, SEED, "cpu")
    c = speech.utterances(22050, lengths, SEED + 1, "cpu")
    assert [len(x) for x in a] == lengths
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert all(x.dtype == np.int16 and np.abs(x).max() > 8000 for x in a)


def test_ljspeech_stretch_lengths_and_keys():
    cfg, mix = Hn.config("ljspeech-22k"), Hn.traffic("corpus")
    lengths = G.corpus_lengths(cfg, mix)
    assert len(lengths) == 512 and len(set(lengths)) == 512
    assert abs(min(lengths) / 22050 - 6.40) < 0.005
    assert abs(max(lengths) / 22050 - 6.75) < 0.005
    batches = G.corpus_batches(lengths, cfg, mix)
    assert len(batches) == 64 and all(c == 8 for _, c, _, _ in batches)
    assert {T for _, _, T, _ in batches} == {143360, 147456, 151552}
    assert {F for _, _, _, F in batches} == {1296, 1312, 1328, 1344, 1360}
    keys = {(T, F) for _, _, T, F in batches}
    assert 6 <= len(keys) <= 8


def test_vctk_stretch_lengths_and_keys():
    """At the source's density (~44,000 clips over 9 s of lengths) the
    stretch spans 0.105 s: three keys, which the graph cache's four
    programs hold, so a pass after the first replays every batch."""
    cfg, mix = Hn.config("vctk-48k"), Hn.traffic("corpus")
    assert cfg["clips_per_length_s"] == round(
        cfg["published"]["clips"]
        / (cfg["length_max_s"] - cfg["length_min_s"]))
    lengths = G.corpus_lengths(cfg, mix)
    assert len(lengths) == 512 and len(set(lengths)) == 512
    assert abs(min(lengths) / 48000 - 3.1227) < 0.001
    assert abs(max(lengths) / 48000 - 3.2273) < 0.001
    batches = G.corpus_batches(lengths, cfg, mix)
    assert len(batches) == 64 and all(c == 8 for _, c, _, _ in batches)
    keys = [(T, F) for _, _, T, F in batches]
    assert sorted(set(keys)) == [(151552, 640), (155648, 640),
                                 (155648, 656)]
    assert [keys.count(k) for k in sorted(set(keys))] == [21, 26, 17]


def test_corpus_batches_match_iter_corpus(tmp_path):
    """The stretch's batches as the program's corpus loader forms them."""
    from worldtpu_torch.io import corpus as CO
    from wtbench.entries import corpus as CE
    cfg = dict(Hn.config("ljspeech-22k"), length_mean_s=0.3,
               clips_per_length_s=200)
    mix = dict(Hn.traffic("corpus"), utterances=10, batch_size=4,
               pad_to=512, frames_to=4)
    lengths = G.corpus_lengths(cfg, mix)
    pcm = speech.utterances(22050, lengths, SEED, "cpu")
    for i, p in enumerate(pcm):
        CE.write_wav(tmp_path / f"u{i:04d}.wav", p, 22050)
    got = list(CO.iter_corpus(tmp_path, 4, fs=22050, pad_to=512,
                              frames_to=4))
    want = G.corpus_batches(lengths, cfg, mix)
    assert [(b.x.shape[1], b.F) for b in got] == [(T, F)
                                                  for _, _, T, F in want]
    order = np.argsort(lengths, kind="stable")
    for b, (first, count, _, _) in zip(got, want):
        for r, i in enumerate(order[first:first + count]):
            assert b.names[r] == f"u{i:04d}"
            assert np.array_equal(b.x[r, :lengths[i]], pcm[i] / 32768.0)
    assert not got[-1].valid[-2:].any()        # the last batch is filled
