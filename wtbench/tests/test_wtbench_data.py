"""The data check: on a copy of wtbench/, a new configuration, traffic mix,
entry, limits file and metric reader are found by name and listed by the
harness, with no file that was there edited."""

import hashlib
import json
import shutil

from wtbench import harness as Hn


def digests(base):
    return {p.relative_to(base): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in base.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    base = tmp_path / "wtbench"
    shutil.copytree(Hn.HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = digests(base)
    cfg = dict(Hn.config("ljspeech-22k", base), name="libritts-24k",
               fs=24000)
    (base / "configs" / "libritts-24k.json").write_text(json.dumps(cfg))
    mix = dict(Hn.traffic("corpus", base), batch_size=16)
    (base / "traffic" / "corpus-b16.json").write_text(json.dumps(mix))
    (base / "limits" / "libritts-24k.corpus-b16.json").write_text(
        json.dumps({"length_mismatch": 0}))
    (base / "metrics" / "codec.host_ms.py").write_text(
        "def read(result):\n    return result.get('codec_ms')\n")
    (base / "entries" / "features.py").write_text(
        "def setup(ctx):\n    return {}\n")
    after = digests(base)
    assert {k: v for k, v in after.items() if k in before} == before
    found = Hn.listing(base)
    assert "libritts-24k" in found["configs"]
    assert "corpus-b16" in found["traffic"]
    assert "features" in found["entries"]
    assert "libritts-24k.corpus-b16" in found["limits"]
    assert "codec.host_ms" in found["metrics"]
    assert Hn.config("libritts-24k", base)["fs"] == 24000
    assert Hn.traffic("corpus-b16", base)["batch_size"] == 16
    assert Hn.limits("libritts-24k.corpus-b16", base) == {
        "length_mismatch": 0}
    reader = Hn.load_module(base / "metrics" / "codec.host_ms.py")
    assert reader.read({"codec_ms": 2.5}) == 2.5
    assert reader.read({}) is None
    assert hasattr(Hn.entry("features", base), "setup")


def test_every_name_in_the_benchmark_has_its_files():
    bench = Hn.load_json(Hn.HERE.parent / "BENCHMARK.json")
    found = Hn.listing()
    for c in bench["configs"]:
        assert c["name"] in found["configs"]
    for w in bench["workloads"]:
        assert w["traffic"] in found["traffic"]
        assert Hn.traffic(w["traffic"])["entry"] in found["entries"]
        assert w["name"] in found["limits"]
    for m in bench["per_layer"]:
        assert m["name"] in found["metrics"]
