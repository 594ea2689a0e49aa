"""Twins of ``tests/test_cli.py``.

Each JAX test runs through both packages (``tests/torch_twin``): both
pass its assertions and leave equal stores, and every ``kubectl`` call the
test makes answers both with the same exit code and output (URL ports and
temporary names masked)."""

from __future__ import annotations

import pytest

from tests.torch_twin import cases, twin

NAME = "test_cli"


@pytest.mark.timeout(60)
@pytest.mark.parametrize("test", cases(NAME))
def test_twin(test, tmp_path):
    twin(NAME, test, tmp_path, echo=["cli.kubectl:main"])
