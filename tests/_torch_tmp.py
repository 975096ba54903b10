"""Temporary files of the port's heaviest test modules, removed once they pass.

A whole run of the suite leaves every test's ``tmp_path`` and every
module's ``tmp_path_factory`` directories under pytest's base temporary
directory; the port's CLI, export and training tests write checkpoints,
exported programs and patch trees there, gigabytes a module, and a run
can fill the disk before it ends. A module that imports both fixtures
(``from tests._torch_tmp import remove_module_tmp, remove_tmp_path  #
noqa: F401``) deletes a test's ``tmp_path`` when that test passed, and at
its end every directory it made under the base directory when none of
its tests failed. A failed test keeps its files, as pytest's own
retention does; what a test checks is not touched.

Failures are read from the session's count, which pytest raises when it
logs a failed report, before the teardown that reads it.
"""

from __future__ import annotations

import shutil

import pytest


@pytest.fixture(autouse=True)
def remove_tmp_path(request):
    # taken at setup: by this fixture's teardown pytest has finalized tmp_path
    path = request.getfixturevalue("tmp_path") if "tmp_path" in request.fixturenames else None
    failed = request.session.testsfailed
    yield
    if path is not None and request.session.testsfailed == failed:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module", autouse=True)
def remove_module_tmp(request, tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    before = set(base.iterdir())
    failed = request.session.testsfailed
    yield
    if request.session.testsfailed == failed:
        for path in set(base.iterdir()) - before:
            shutil.rmtree(path, ignore_errors=True)
