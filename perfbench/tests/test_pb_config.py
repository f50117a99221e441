"""A configuration file's architecture and its cut: the keys of the file's
top level that are the model's own reach the program's model and the
plug-in as ``Cell.arch``; ``model`` holds ``Config`` fields only; a cut is
listed in ``reduced`` with its published value and its deployment. A file
that breaks any of this stops set-up with a message that names the key and
the fix, never a bare ``TypeError``."""

import dataclasses

import pytest

from harness import cell as cell_lib

ST = "st_resnet152_bf16.bulk_beam3"
SEED = 2**31 + 777
TINY = {"model": {"embed_size": 16, "hidden_size": 24, "crop_size": 32}, "vocab_size": 40}
CUT = {"num_hidden_layers": 4, "reduced": ["num_hidden_layers"], "published": {"num_hidden_layers": 27},
       "deployment": "each layer whole on one chip; the left-out layers on further chips, as pipeline stages"}


def with_file(**changes):
    """The ST cell with its configuration file changed: ``Cell`` checks the
    file as ``Cell.find`` reads it, before any set-up."""
    c = cell_lib.Cell.find(ST, TINY)
    config = {**c.config, **changes}
    return dataclasses.replace(c, config={k: v for k, v in config.items() if v is not None})


def test_a_non_config_key_under_model_names_the_key_and_where_it_goes():
    model = {**cell_lib.Cell.find(ST).config["model"], "kv_lora_rank": 512}
    with pytest.raises(SystemExit, match=r"'model' holds 'kv_lora_rank'.*top level of the configuration file"):
        with_file(model=model)


def test_a_key_both_under_model_and_at_the_top_level_stops():
    with pytest.raises(SystemExit, match=r"'hidden_size' is both a Config field under 'model' and an architecture"):
        with_file(hidden_size=2048)


@pytest.mark.parametrize("changes,match", [
    ({"published": None}, r"'reduced' lists 'num_hidden_layers' without a differing published value"),
    ({"published": {"num_hidden_layers": 4}}, r"'num_hidden_layers' without a differing published value"),
    ({"reduced": ["n_routed_experts"]}, r"'reduced' lists 'n_routed_experts', which the file does not set"),
    ({"reduced": ["model"]}, r"'reduced' lists 'model', which the file does not set"),
    ({"head_dim": 64, "reduced": ["head_dim"], "published": {"head_dim": 128}}, r"'head_dim', a width"),
    ({"deployment": None}, r"without a 'deployment'"),
], ids=["no_published", "published_equal", "not_set", "harness_key", "a_width", "no_deployment"])
def test_an_undocumented_cut_stops(changes, match):
    with pytest.raises(SystemExit, match=match):
        with_file(**{**CUT, **changes})


def test_a_documented_cut_and_the_arch_it_carries():
    c = with_file(**CUT, rope_theta=800000.0, vocab_size=40)
    assert c.arch == {"num_hidden_layers": 4, "rope_theta": 800000.0}
    c = with_file(vocab_size=163840 // 8, reduced=["vocab_size"], published={"vocab_size": 163840},
                  deployment="the vocabulary in eighths over eight chips; this chip holds one")
    assert c.arch == {}
    # the CPU tests' overrides merge over the file's
    c = dataclasses.replace(with_file(**CUT), overrides={"arch": {"num_hidden_layers": 2}})
    assert c.arch == {"num_hidden_layers": 2}


@pytest.fixture
def registry():
    from show_and_tell_tpu_torch.models import registry

    return registry


def test_without_arch_the_program_is_built_as_before(registry, monkeypatch):
    calls, build = [], registry.build_model

    def spy(*a, **kw):
        calls.append((a, kw))
        return build(*a, **kw)

    monkeypatch.setattr(registry, "build_model", spy)
    c = cell_lib.Cell.find(ST, TINY)
    cell_lib.build_model(c, SEED, "cpu")
    assert calls == [((c.port_config(), 40), {"device": "cpu"})]


def test_with_arch_the_program_gets_it(registry, monkeypatch):
    """The class the registry holds, called as ``build_model`` calls it,
    with ``arch``; a model the program lacks stops set-up by its name."""
    base, got = registry.MODELS["show_tell"], []

    class Recorded(base):
        def __init__(self, cfg, vocab_size, device="cuda", generator=None, arch=None):
            got.append((cfg, vocab_size, device, generator, arch))
            super().__init__(cfg, vocab_size, device=device, generator=generator)

    monkeypatch.setitem(registry.MODELS, "show_tell", Recorded)
    c = dataclasses.replace(cell_lib.Cell.find(ST, TINY), overrides={**TINY, "arch": {"rope_theta": 10000.0}})
    model, _ = cell_lib.build_model(c, SEED, "cpu")
    assert isinstance(model, Recorded) and got == [(c.port_config(), 40, "cpu", None, {"rope_theta": 10000.0})]
    monkeypatch.delitem(registry.MODELS, "show_tell")
    with pytest.raises(SystemExit, match="the program has no model 'show_tell'"):
        cell_lib.build_model(c, SEED, "cpu")
