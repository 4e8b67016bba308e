"""Argparse-defaults parity against the reference parsers.

The reference's defaults ARE behaviour for drop-in users (a laxer
--max-pi-dist silently changes which genomes survive QC), so every
shared option's default is diffed against the reference parser itself:
the reference's ``get_options`` is imported from /root/reference (with
its binary deps stubbed) and its parser defaults are captured by
intercepting ``parse_args``.  No hand-frozen table to rot.

Reference: PopPUNK/__main__.py:17-26 (module defaults), :40-240 (parser);
PopPUNK/assign.py:30-140.
"""

import argparse
import sys
import types

import pytest

REFERENCE = "/root/reference"

# Dests that intentionally differ / don't apply:
#  - use_gpu etc. parse as no-ops here (offload is automatic);
#  - our parsers add device-specific options the reference lacks.
# Every dest present in BOTH parsers must match unless listed here
# with a justification.
EXEMPT = {
    "main": {
        # argparse internals
        "help", "version",
    },
    "assign": {
        "help", "version",
    },
}


class _Captured(Exception):
    def __init__(self, defaults):
        self.defaults = defaults


def _capture(get_options):
    """Run a get_options() and capture the parser's defaults at the
    moment parse_args is called (before any post-parse validation)."""
    orig = argparse.ArgumentParser.parse_args

    def intercept(self, *a, **k):
        raise _Captured({act.dest: act.default for act in self._actions})

    argparse.ArgumentParser.parse_args = intercept
    try:
        try:
            get_options()
        except _Captured as c:
            return c.defaults
        except TypeError:
            try:
                get_options([])
            except _Captured as c:
                return c.defaults
        raise AssertionError("parse_args never reached")
    finally:
        argparse.ArgumentParser.parse_args = orig


@pytest.fixture(scope="module")
def reference_defaults():
    """Import the reference parsers with binary deps stubbed."""
    sys.path.insert(0, REFERENCE)
    stubbed = []
    for mod in ("pp_sketchlib", "graph_tool", "graph_tool.all"):
        if mod not in sys.modules:
            sys.modules[mod] = types.ModuleType(mod)
            stubbed.append(mod)
    try:
        from PopPUNK.__main__ import get_options as ref_main
        from PopPUNK.assign import get_options as ref_assign
        yield {"main": _capture(ref_main), "assign": _capture(ref_assign)}
    finally:
        sys.path.remove(REFERENCE)
        for mod in stubbed:
            del sys.modules[mod]
        for mod in [m for m in sys.modules if m.startswith("PopPUNK")]:
            del sys.modules[mod]


def _diff(ours, refs, exempt):
    shared = (set(ours) & set(refs)) - exempt
    bad = {}
    for dest in sorted(shared):
        if ours[dest] != refs[dest]:
            bad[dest] = (ours[dest], refs[dest])
    return bad


def test_main_cli_defaults_match_reference(reference_defaults):
    from poppunk_tpu.cli.main import get_options
    ours = _capture(get_options)
    bad = _diff(ours, reference_defaults["main"], EXEMPT["main"])
    assert not bad, (
        "main CLI defaults diverge from the reference parser "
        "(ours, reference): " + repr(bad))


def test_assign_cli_defaults_match_reference(reference_defaults):
    from poppunk_tpu.cli.assign import get_options
    ours = _capture(get_options)
    bad = _diff(ours, reference_defaults["assign"], EXEMPT["assign"])
    assert not bad, (
        "assign CLI defaults diverge from the reference parser "
        "(ours, reference): " + repr(bad))


def test_default_qc_dict_matches_reference_module_defaults(reference_defaults):
    """qc.DEFAULT_QC mirrors the reference's module-level QC constants
    (PopPUNK/__main__.py:17-26) and the parser defaults they feed."""
    from poppunk_tpu.qc import DEFAULT_QC
    ref = reference_defaults["main"]
    assert DEFAULT_QC["max_pi_dist"] == ref["max_pi_dist"] == 0.1
    assert DEFAULT_QC["max_a_dist"] == ref["max_a_dist"] == 0.5
    assert DEFAULT_QC["prop_zero"] == ref["max_zero_dist"] == 0.05
    assert DEFAULT_QC["length_sigma"] == ref["length_sigma"] == 5
    assert DEFAULT_QC["prop_n"] == ref["prop_n"] == 0.1
    assert DEFAULT_QC["x"] == ref["x"] == 0.2
    assert DEFAULT_QC["r"] == ref["r"] == 50
    assert DEFAULT_QC["max_merge"] == -1


def test_shared_dest_coverage(reference_defaults):
    """Every reference main-CLI dest exists in our parser (flag-surface
    audit; values checked above)."""
    from poppunk_tpu.cli.main import get_options
    ours = set(_capture(get_options))
    missing = set(reference_defaults["main"]) - ours - EXEMPT["main"]
    assert not missing, f"reference main flags absent here: {sorted(missing)}"
