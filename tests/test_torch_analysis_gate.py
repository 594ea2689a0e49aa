"""The port's analysis gate on its own tree: all seven passes of
``kubernetes_tpu_torch.analysis`` find nothing the port's baseline does
not hold, no baseline entry is stale, the run fits the tier-1 budget
(< 60 s), and ``--changed`` scopes the report to the diff.

These are the JAX package's tests, run on the port alone
(``tests/torch_twin.run``, every ``kubernetes_tpu`` renamed): the JAX
package's own gate is red on its tree, so the two packages are not both
required to pass them here."""

from __future__ import annotations

import pytest

from tests.torch_twin import run

NAME = "test_static_analysis"


@pytest.mark.timeout(300)
@pytest.mark.parametrize("test", ["test_live_tree_clean", "test_analyzer_wall_time_budget",
                                  "test_cli_changed_scopes_report_to_diff"])
def test_on_the_port(test, tmp_path):
    run(NAME, test, "port", tmp_path)
