"""launch/accounting.py and the shape table of configs/__init__.py against
the JAX package: the same cells, and for every one of the 33 run cells the
same parameter counts and every ``Cost`` field equal, each cell's config
from its own package's ``specs.cell_config``."""
import dataclasses

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.launch import accounting as jaccounting
from repro.launch import specs as jspecs
from repro_torch import configs as tconfigs
from repro_torch.launch import accounting, specs


def test_the_shape_tables_are_the_reference_s():
    assert {k: dataclasses.astuple(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.LONG_OK == jconfigs.LONG_OK
    assert set(tconfigs.ARCHS) == set(jconfigs.ARCHS)
    for arch in jconfigs.ARCHS:
        assert [s.name for s in tconfigs.cells(arch)] == \
            [s.name for s in jconfigs.cells(arch)]
        assert tconfigs.skipped_cells(arch) == jconfigs.skipped_cells(arch)
    cells = {(a, s.name) for a, s in tconfigs.all_cells()}
    assert cells == {(a, s.name) for a, s in jconfigs.all_cells()}
    assert len(cells) == 33


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_step_cost_equals_the_reference_on_every_cell(arch):
    t, a = accounting.param_counts(tconfigs.get_config(arch))
    assert (t, a) == jaccounting.param_counts(jconfigs.get_config(arch))
    assert accounting.embed_params(tconfigs.get_config(arch)) == \
        jaccounting.embed_params(jconfigs.get_config(arch))
    for shape in tconfigs.cells(arch):
        got = accounting.step_cost(specs.cell_config(arch, shape), shape)
        jshape = jconfigs.SHAPES[shape.name]
        want = jaccounting.step_cost(jspecs.cell_config(arch, jshape),
                                     jshape)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), \
            (arch, shape.name)
        assert got.flops > 0 and got.hbm_bytes > 0


def test_cell_config_overrides_are_the_reference_s():
    for arch, shape in tconfigs.all_cells():
        got = specs.cell_config(arch, shape)
        want = jspecs.cell_config(arch, jconfigs.SHAPES[shape.name])
        for f in ("shard_kv_seq", "q_chunk", "kv_chunk", "groups",
                  "encoder_groups"):
            assert getattr(got, f) == getattr(want, f), (arch, shape.name, f)
        assert str(got.param_dtype).removeprefix("torch.") == \
            np.dtype(want.param_dtype).name
        assert specs.rule_overrides(got) == jspecs.rule_overrides(want)
    probe = {0: 2}
    for arch in ("qwen2-0.5b", "whisper-medium", "zamba2-1.2b"):
        shape = tconfigs.SHAPES["train_4k"]
        assert specs.cell_config(arch, shape, probe).groups == \
            jspecs.cell_config(arch, jconfigs.SHAPES["train_4k"],
                               probe).groups
        assert specs.group_counts(arch) == jspecs.group_counts(arch)
    assert specs.GRAD_ACCUM == jspecs.GRAD_ACCUM
