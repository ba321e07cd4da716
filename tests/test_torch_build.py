"""``gpax_torch/ops/build.py`` compiles every CUDA source under
``gpax_torch/csrc`` and hashes every header there into the library's name,
so that an edited header is never served by a stale library: its lists must
name exactly the files there, and each header must be included by a source
or by another header. No nvcc needed."""

import re

import pytest

from gpax_torch.ops import build


def test_sources_and_headers_name_every_file_in_csrc():
    assert sorted(build.SOURCES) == sorted(p.name for p in build.CSRC.glob("*.cu"))
    assert sorted(build.HEADERS) == sorted(p.name for p in build.CSRC.glob("*.cuh"))


@pytest.mark.parametrize("header", build.HEADERS)
def test_every_header_is_included(header):
    includes = set()
    for name in build.SOURCES + build.HEADERS:
        if name != header:
            text = (build.CSRC / name).read_text()
            includes.update(re.findall(r'#include "([^"]+)"', text))
    assert header in includes
