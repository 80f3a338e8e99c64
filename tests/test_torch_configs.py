"""The port's copy of the configuration registry is the reference's, field
for field: every registered config, its reduced() form, its derived
properties and its parameter counts."""
import dataclasses

import pytest

pytest.importorskip("torch")

import repro.configs as jcfg  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402

ARCHS = jcfg.list_archs()


def test_registry_names_match():
    assert tcfg.list_archs() == ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    ref, port = jcfg.get_config(arch), tcfg.get_config(arch)
    assert type(port).__module__ == "repro_torch.configs.base"
    for r, p in ((ref, port), (ref.reduced(), port.reduced()),
                 (ref.scaled(window=16), port.scaled(window=16))):
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert p.blocks_in_group == r.blocks_in_group
        assert (p.period, p.n_groups) == (r.period, r.n_groups)
        assert p.param_counts() == r.param_counts()
        assert (p.effective_moe_d_ff, p.mamba_d_inner, p.n_rwkv_heads) == (
            r.effective_moe_d_ff, r.mamba_d_inner, r.n_rwkv_heads)


def test_unknown_arch_raises_and_pattern_is_checked():
    with pytest.raises(KeyError):
        tcfg.get_config("no-such-arch")
    with pytest.raises(AssertionError):
        tcfg.get_config("qwen1.5-4b").scaled(block_pattern=("attn",) * 3)
