"""make_block_sparse_attention(impl="resident") against the reference's
"resident" route, its Pallas kernels in interpret mode: every layout family,
causal and not, forward within 2e-5 and gradients within 5e-4 (fp32, the
reference's own tolerances). The check is ``check_factory`` of
tests/test_torch_sparse_attention.py."""

import pytest

from tests.test_torch_sparse_attention import FACTORY_CASES, check_factory


@pytest.mark.parametrize("name,causal", FACTORY_CASES)
def test_factory_matches_the_resident_route(name, causal):
    check_factory(name, causal, "resident")
