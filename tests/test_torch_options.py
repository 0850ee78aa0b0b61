"""Port ``Options`` (iterativelqr_tpu_torch/core/options.py) against the JAX
package's: same fields, defaults, validation and candidate-grid size."""

import dataclasses

import pytest
import torch

from iterativelqr_tpu import Options as JaxOptions
from iterativelqr_tpu_torch import Options
from iterativelqr_tpu_torch.convert import options_from_fields

torch.set_num_threads(1)

# the bench.py presets the port must reproduce (bench.py:179-237)
TUNED = dict(verbose=False, record_traces=False,
             initial_constraint_penalty=1000.0, min_step_size=4e-3,
             early_round_iteration_cap=20)
PARITY = dict(verbose=False, record_traces=False)


def test_same_fields_and_defaults():
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxOptions)]
    tf = [(f.name, f.default) for f in dataclasses.fields(Options)]
    assert tf == jf


@pytest.mark.parametrize("kw,na", [({}, 17), (TUNED, 8), (PARITY, 17)])
def test_presets_field_for_field(kw, na):
    j, t = JaxOptions(**kw), Options(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.num_step_sizes == j.num_step_sizes == na
    # the carry-over path the parity tests use
    assert options_from_fields(dataclasses.asdict(j)) == t


@pytest.mark.parametrize("bad", [
    dict(line_search="wolfe"),
    dict(backward_pass="pallas"),
    dict(backward_pass="nope"),
    dict(batched_solver="nope"),
    dict(ddp=True, backward_pass="packed"),
    dict(ddp=True, batched_solver="sl"),
    dict(forward_kernel="nope"),
    dict(max_total_iterations=0),
    dict(truncation_progress_factor=0.0),
    dict(early_round_iteration_cap=0),
    dict(max_consecutive_truncations=0),
])
def test_same_validation(bad):
    with pytest.raises(ValueError):
        JaxOptions(**bad)
    with pytest.raises(ValueError):
        Options(**bad)


@pytest.mark.parametrize("min_step", [0.0, 1e-1, 0.5, 1.0, 3e-7])
def test_num_step_sizes_edges(min_step):
    kw = dict(min_step_size=min_step)
    assert Options(**kw).num_step_sizes == JaxOptions(**kw).num_step_sizes
