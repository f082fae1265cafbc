"""The port's LLM configs against the reference's ``repro.configs``.

``repro_torch.configs`` is a copy (stdlib only): every field of all ten
architectures, the analytic parameter counts (total and active), the
expanded layer patterns, ``reduced(...)``, ``padded_vocab``,
``sub_quadratic`` and the 40-cell assignment grid must equal the
reference's exactly.
"""
import dataclasses
import importlib

import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402

ARCH_IDS = list(jconfigs.ARCHS)
ARCH_MODULES = ["command_r_35b", "command_r_plus_104b", "falcon_mamba_7b",
                "internlm2_20b", "llama32_vision_11b", "mixtral_8x22b",
                "phi35_moe_42b", "qwen15_05b", "recurrentgemma_2b",
                "whisper_large_v3"]


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_registry_order_and_names():
    assert list(tconfigs.ARCHS) == list(jconfigs.ARCHS)
    assert len(tconfigs.ARCHS) == 10
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    with pytest.raises(KeyError):
        tconfigs.get_arch("no-such-arch")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_fields_equal(arch):
    t, j = tconfigs.get_arch(arch), jconfigs.get_arch(arch)
    assert _fields(t) == _fields(j)
    assert type(t).__module__ == "repro_torch.configs.base"


@pytest.mark.parametrize("module", ARCH_MODULES)
def test_arch_files_keep_their_source_docstrings(module):
    t = importlib.import_module(f"repro_torch.configs.{module}")
    j = importlib.import_module(f"repro.configs.{module}")
    assert t.__doc__ == j.__doc__ and "[" in t.__doc__
    assert _fields(t.CONFIG) == _fields(j.CONFIG)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_derived_quantities_equal(arch):
    t, j = tconfigs.get_arch(arch), jconfigs.get_arch(arch)
    assert t.param_count() == j.param_count()
    assert t.param_count(active_only=True) == j.param_count(active_only=True)
    assert t.pattern_for_layers() == j.pattern_for_layers()
    assert t.padded_vocab() == j.padded_vocab()
    assert t.padded_vocab(128) == j.padded_vocab(128)
    assert t.sub_quadratic == j.sub_quadratic
    assert t.kq_dim == j.kq_dim and t.dt_rank_() == j.dt_rank_()
    assert t.is_attention_free == j.is_attention_free


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_equal(arch):
    for vocab in (512, 1000):
        t = tconfigs.reduced(tconfigs.get_arch(arch), vocab=vocab)
        j = jconfigs.reduced(jconfigs.get_arch(arch), vocab=vocab)
        assert _fields(t) == _fields(j)
        assert t.param_count() == j.param_count()
        assert t.pattern_for_layers() == j.pattern_for_layers()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_applicable_equal(arch):
    for s in tconfigs.SHAPES.values():
        assert tconfigs.shape_applicable(tconfigs.get_arch(arch), s) == \
            jconfigs.shape_applicable(jconfigs.get_arch(arch),
                                      jconfigs.get_shape(s.name))
        assert dataclasses.asdict(s) == \
            dataclasses.asdict(jconfigs.get_shape(s.name))


def test_all_cells_40_with_7_skipped():
    cells = list(tconfigs.all_cells())
    assert cells == list(jconfigs.all_cells())
    assert len(cells) == 40
    skipped = [c for c in cells if not c[2]]
    assert len(skipped) == 7
    assert all(c[1] == "long_500k" for c in skipped)
