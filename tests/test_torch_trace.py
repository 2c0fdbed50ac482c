"""``client_tpu_torch.trace`` against ``client_tpu.trace``.

The port's trace module is a copy of the JAX package's, and the contract is
the file on disk: the same generator, seed and spec give a byte-identical
JSONL trace in both packages, each package loads the other's file into the
same records, and malformed or newer-version lines fail or are skipped the
same way (the same ``TraceParseError`` line and message, the same skip
count).
"""

import io
import json

import pytest

from client_tpu import trace as jax_trace
from client_tpu_torch import trace as port_trace

# every generator, with the knobs that change what it draws (hot keys,
# tenants, adversaries, the v2/v5/v6 record kinds, the tails)
SPECS = [
    "poisson_burst:duration_s=2,rate=40",
    "poisson_burst:duration_s=3,rate=25,burst_factor=3,duty=0.3",
    "heavy_tail:duration_s=2,rate=10",
    "heavy_tail:duration_s=2,rate=10,tail=pareto,alpha=1.5",
    "mixed:duration_s=3,rate=30,stream_fraction=0.2,seq_fraction=0.15,"
    "output_mean=4,max_output=6",
    "mixed:duration_s=2,rate=20,hot_key_universe=16",
    "mixed:duration_s=2,rate=20,shard_fraction=0.1,disagg_fraction=0.1,"
    "pipeline_fraction=0.1",
    "sharded:duration_s=2,rate=20,shards=2",
    "sharded:duration_s=2,rate=10,shards=4,batch=8",
    "multi_tenant:duration_s=2,tenants=3,rate=10,adversaries=1",
    "multi_tenant:duration_s=2,tenants=2,rate=10,hot_key_universe=8",
]
SEEDS = (0, 1, 7)
CASES = [(spec, seed) for spec in SPECS for seed in SEEDS]
IDS = [f"{spec.split(':')[0]}{SPECS.index(spec)}-seed{seed}" for spec, seed in CASES]


def _text(mod, spec, seed):
    tr = mod.generate(spec, seed=seed)
    return mod.dumps_trace(tr.records, tr.header)


@pytest.mark.parametrize("spec, seed", CASES, ids=IDS)
def test_dumps_byte_identical(spec, seed):
    port = _text(port_trace, spec, seed)
    assert port.encode() == _text(jax_trace, spec, seed).encode()
    assert len(port.splitlines()) > 1


@pytest.mark.parametrize("spec, seed", CASES, ids=IDS)
def test_each_package_loads_the_others_file(spec, seed, tmp_path):
    jax_file = tmp_path / "jax.jsonl"
    port_file = tmp_path / "port.jsonl"
    jtr = jax_trace.generate(spec, seed=seed)
    ptr = port_trace.generate(spec, seed=seed)
    jax_trace.dump_trace(jtr.records, str(jax_file), header=jtr.header)
    port_trace.dump_trace(ptr.records, str(port_file), header=ptr.header)
    by_port = port_trace.load_trace(str(jax_file))
    by_jax = jax_trace.load_trace(str(port_file))
    assert [r.to_obj() for r in by_port.records] == [r.to_obj() for r in jtr.records]
    assert [r.to_obj() for r in by_jax.records] == [r.to_obj() for r in ptr.records]
    assert by_port.header == by_jax.header
    assert by_port.skipped == by_jax.skipped == 0
    assert by_port.kind_counts() == by_jax.kind_counts()
    assert by_port.duration_s == by_jax.duration_s


@pytest.mark.parametrize("spec", ["poisson_burst:duration_s=1,rate=5",
                                  "heavy_tail:duration_s=1,rate=5",
                                  "mixed:duration_s=1,rate=10"])
def test_dump_to_a_file_object_equal(spec):
    texts = []
    for mod in (jax_trace, port_trace):
        tr = mod.generate(spec, seed=3)
        buf = io.StringIO()
        mod.dump_trace(tr.records, buf, header=tr.header)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]


def _valid_lines():
    tr = jax_trace.generate("poisson_burst:duration_s=1,rate=20", seed=0)
    return jax_trace.dumps_trace(tr.records, tr.header).splitlines()


def _parse_error(mod, text):
    with pytest.raises(mod.TraceParseError) as exc:
        mod.loads_trace(text)
    return exc.value.line, str(exc.value)


def _mutated(mutation):
    lines = _valid_lines()
    obj = json.loads(lines[1])
    mutation(obj)
    lines[1] = json.dumps(obj)
    return "\n".join(lines)


MALFORMED = {
    "not json": "\n".join(_valid_lines()[:2] + ["{not json"] + _valid_lines()[3:]),
    "not an object": "\n".join(_valid_lines()[:1] + ["[1, 2]"]),
    "no at_s": _mutated(lambda o: o.pop("at_s")),
    "negative at_s": _mutated(lambda o: o.update(at_s=-1.0)),
    "unknown kind": _mutated(lambda o: o.update(kind="nope")),
    "no model": _mutated(lambda o: o.pop("model")),
    "non-integer version": _mutated(lambda o: o.update(v="x")),
    "unary without shapes": json.dumps(
        {"type": "request", "at_s": 0.1, "kind": "unary", "model": "simple"}),
    "stream without prompt_tokens": json.dumps(
        {"type": "request", "at_s": 0.1, "kind": "generate_stream", "model": "m"}),
    "sequence index past its length": json.dumps(
        {"type": "request", "at_s": 0.1, "kind": "sequence", "model": "m",
         "seq_group": 1, "seq_index": 5, "seq_len": 3,
         "shapes": {"INPUT": [1, 1]}, "dtypes": {"INPUT": "INT32"}}),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_lines_fail_the_same_way(case):
    text = MALFORMED[case]
    assert _parse_error(port_trace, text) == _parse_error(jax_trace, text)


NEWER = {
    "a record from a newer format": json.dumps(
        {"type": "request", "v": jax_trace.TRACE_VERSION + 1, "kind": "teleport",
         "model": "m", "at_s": 0.5, "wormhole": True}),
    "an unknown record type": json.dumps({"type": "annotation", "note": "hi"}),
}


@pytest.mark.parametrize("case", sorted(NEWER))
def test_newer_version_records_skip_the_same_way(case):
    lines = _valid_lines()
    lines.insert(2, NEWER[case])
    text = "\n".join(lines)
    port, ref = port_trace.loads_trace(text), jax_trace.loads_trace(text)
    assert port.skipped == ref.skipped == 1
    assert [r.to_obj() for r in port.records] == [r.to_obj() for r in ref.records]


def test_whole_file_from_a_newer_format_skips_all():
    text = "\n".join([
        json.dumps({"type": "header", "version": jax_trace.TRACE_VERSION + 7}),
        json.dumps({"type": "request", "kind": "quantum", "at_s": 0.0}),
        json.dumps({"type": "request", "kind": "unary", "model": "m", "at_s": 0.1}),
    ])
    port, ref = port_trace.loads_trace(text), jax_trace.loads_trace(text)
    assert port.records == [] and port.skipped == ref.skipped == 2


def test_versions_and_kinds_equal():
    assert port_trace.TRACE_VERSION == jax_trace.TRACE_VERSION
    assert port_trace.BASE_VERSION == jax_trace.BASE_VERSION
    assert port_trace.KINDS == jax_trace.KINDS
    assert sorted(port_trace.GENERATORS) == sorted(jax_trace.GENERATORS)


@pytest.mark.parametrize("spec", [
    "nope:rate=1", "mixed:rate", "mixed:stream_fraction=0.9,seq_fraction=0.5",
    "mixed:bogus=1", "sharded:shards=0", "multi_tenant:tenants=0",
])
def test_bad_specs_raise_the_same(spec):
    errors = []
    for mod in (jax_trace, port_trace):
        with pytest.raises(ValueError) as exc:
            mod.generate(spec, seed=0)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("seed, key", [(0, 0), (0, 5), (3, 5), (11, 2)])
def test_key_rng_streams_equal(seed, key):
    a = jax_trace._key_rng(seed, key).integers(0, 1 << 30, size=16)
    b = port_trace._key_rng(seed, key).integers(0, 1 << 30, size=16)
    assert (a == b).all()
