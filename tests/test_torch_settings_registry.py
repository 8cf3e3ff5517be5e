"""cuopt_torch's string-keyed SolverSettings registry against cuopt_tpu's
(lp/settings.py:121-256): the same names, types, casts, shared LP/MIP
fields and errors."""

import math

import pytest
import torch

from cuopt_tpu.lp.settings import SolverSettings as TpuSettings
from cuopt_tpu.utils.errors import ValidationError as TpuValidationError
from cuopt_torch.lp.settings import SolverSettings
from cuopt_torch.utils.errors import ValidationError

torch.set_num_threads(1)

NAMES = TpuSettings().parameter_names()

# a value of each type that differs from every default, and a string form
# that set_parameter must cast the same way
SAMPLES = {float: (0.125, "0.125"), int: (3, "3"), bool: (False, "false"),
           str: ("out.sol", "out.sol")}


def test_names_and_types_equal_cuopt_tpu():
    port = SolverSettings()
    assert port.parameter_names() == NAMES
    assert len(NAMES) == 30
    for name in NAMES:
        assert port.parameter_type(name) is \
            TpuSettings().parameter_type(name), name


@pytest.mark.parametrize("name", NAMES)
def test_set_get_round_trip(name):
    kind = TpuSettings().parameter_type(name)
    for value in SAMPLES[kind]:
        port, tpu = SolverSettings(), TpuSettings()
        assert port.get_parameter(name) == tpu.get_parameter(name)
        port.set_parameter(name, value)
        tpu.set_parameter(name, value)
        got = port.get_parameter(name)
        assert type(got) is kind
        assert got == tpu.get_parameter(name) == kind(SAMPLES[kind][0])
        # the fields that set_parameter keeps shared between LP and MIP
        for attr in ("time_limit", "log_file", "log_to_console"):
            assert getattr(port.mip, attr) == getattr(tpu.mip, attr)


def test_time_limit_reaches_both_settings():
    port = SolverSettings()
    port.set_parameter("time_limit", "12.5")
    assert port.pdlp.time_limit == port.mip.time_limit == 12.5
    assert math.isinf(SolverSettings().mip.time_limit)


def test_user_problem_file_is_stored():
    port = SolverSettings()
    port.set_parameter("user_problem_file", "model.mps")
    assert port.pdlp.user_problem_file == "model.mps"
    assert port.mip.user_problem_file == ""


@pytest.mark.parametrize("call", [
    lambda s: s.set_parameter("no_such_parameter", 1),
    lambda s: s.get_parameter("no_such_parameter"),
    lambda s: s.parameter_type("no_such_parameter"),
    lambda s: s.set_parameter("crossover", "maybe"),
])
def test_errors_equal_cuopt_tpu(call):
    with pytest.raises(TpuValidationError) as want:
        call(TpuSettings())
    with pytest.raises(ValidationError) as got:
        call(SolverSettings())
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("text", ["1", "true", "Yes", "on", "0", "FALSE",
                                  "no", "off"])
def test_boolean_spellings(text):
    port, tpu = SolverSettings(), TpuSettings()
    port.set_parameter("crossover", text)
    tpu.set_parameter("crossover", text)
    assert port.get_parameter("crossover") is tpu.get_parameter("crossover")
