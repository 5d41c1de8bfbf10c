"""The port's adversarial scenario search (repro_torch.cluster.search)
against the JAX package on the CPU: the search-smoke configuration of
benchmarks/scenario_search.py (one seed, a 20-node fleet, the smoke
workload, invariants on), cut to three evaluations, gives the reference's
result apart from provenance: the same proposals, regrets, acceptances and
ranking.  The full eight evaluations run on the card and the CPU in
chip_smoke.py's ``search`` phase."""

import json

import pytest

from repro.cluster import search as jsearch
from repro_torch.cluster import search as tsearch

CPU = "cpu"
SMOKE = dict(budget=3, seeds=1, fleet_size=20, scenario="baseline",
             workload="smoke", executor="serial", check_invariants=True,
             min_samples=40, max_train=2000)


def _quiet(*a, **k):
    pass


def _without_provenance(result) -> dict:
    out = json.loads(tsearch.search_json(result))
    assert out.pop("provenance")["pr"]
    return out


@pytest.fixture(scope="module")
def reference():
    return jsearch.run_search(jsearch.SearchConfig(**SMOKE), log=_quiet)


def test_smoke_search_matches_reference(reference):
    got = tsearch.run_search(tsearch.SearchConfig(**SMOKE), device=CPU,
                             log=_quiet)
    assert _without_provenance(got) == _without_provenance(reference)
    assert [e["origin"] for e in got["evals"]] == ["init", "perturb",
                                                   "perturb"]
    assert any(e["regret"] != 0.0 for e in got["evals"])
    assert sum(e["violations"] for e in got["evals"]) == 0
    assert sum(e["checks"] for e in got["evals"]) > 0
    assert tsearch.search_markdown(got).splitlines()[0] \
        == "# Adversarial scenario search"


def test_config_and_regret_match_reference():
    assert tsearch.SearchConfig(**SMOKE).to_json() \
        == jsearch.SearchConfig(**SMOKE).to_json()
    base = {"pct_tasks_failed": 4.0, "pct_jobs_failed": 1.0,
            "sim_time": 1000.0}
    atlas = {"pct_tasks_failed": 2.5, "pct_jobs_failed": 2.0,
             "sim_time": 1100.0}
    for cfg in (dict(), dict(w_tasks=0.5, w_makespan=1.0)):
        assert tsearch.regret_for(base, atlas, tsearch.SearchConfig(**cfg)) \
            == jsearch.regret_for(base, atlas, jsearch.SearchConfig(**cfg))


def test_search_resumes_from_its_ledger(reference, tmp_path):
    """Two evaluations, then a resume to three, equal three straight (and
    so the reference's); a ledger from another config is refused."""
    short = tsearch.SearchConfig(**{**SMOKE, "budget": 2})
    tsearch.run_search(short, out_dir=tmp_path, device=CPU, log=_quiet)
    lines = []
    resumed = tsearch.run_search(tsearch.SearchConfig(**SMOKE),
                                 out_dir=tmp_path, device=CPU,
                                 log=lines.append)
    assert any("resumed 2 evals" in line for line in lines)
    assert _without_provenance(resumed) == _without_provenance(reference)
    assert json.loads((tmp_path / "SEARCH.json").read_text())["n_evals"] == 3
    with pytest.raises(ValueError, match="different SearchConfig"):
        tsearch.run_search(tsearch.SearchConfig(**{**SMOKE, "seed": 1}),
                           out_dir=tmp_path, device=CPU, log=_quiet)
