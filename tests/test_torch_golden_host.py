"""The port's CLI with the host engine (index.py join + torch verify, on
the CPU) against the golden artifacts: all 12 staged artifacts byte-equal
and the normalized log equal, for the nine golden configs.  A file of its
own so that the suite's workers split the golden runs."""

import os

import pytest

from logutil import assert_log_equal
from test_torch_golden import CONFIGS, GOLDEN, _check_artifacts, _run


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_golden_config_host(name, tmp_path):
    proc = _run(tmp_path, CONFIGS[name], engine="host")
    _check_artifacts(tmp_path, name)
    assert_log_equal(proc.stdout,
                     os.path.join(GOLDEN, "out", name, "log.txt"),
                     "%s/torch-host" % name)
