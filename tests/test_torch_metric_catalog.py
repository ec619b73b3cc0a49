"""The port's metric-catalog lint (sentinel_tpu_torch/analysis/
metrics_catalog.py): counterparts of tests/test_metric_catalog.py, each
held against the reference's lint on the same temporary trees."""

from __future__ import annotations

import os
import textwrap

from sentinel_tpu.analysis import metrics_catalog as REF
from sentinel_tpu_torch.analysis.metrics_catalog import (
    check_catalog,
    readme_catalog_names,
    scan_registered_metrics,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_repo_catalog_is_clean():
    """Every sentinel_* metric the port registers is cataloged in the
    README (the shared table or the port's own), every row is live, every
    name is snake_case — and the reference's lint agrees on the port."""
    pkg, readme = os.path.join(REPO, "sentinel_tpu_torch"), os.path.join(REPO, "README.md")
    problems = check_catalog(pkg, readme)
    assert problems == [], "\n".join(problems)
    assert REF.check_catalog(pkg, readme) == []
    # the port's own table is read by the port's parser only: the shared
    # table the reference's lint holds its package to stays the same
    assert REF.readme_catalog_names(readme) == [
        n for n in readme_catalog_names(readme) if n in set(REF.readme_catalog_names(readme))
    ]


def test_scanner_finds_literal_registrations(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "m.py").write_text(
        textwrap.dedent(
            """\
            REG.counter("sentinel_good_total", "h")
            REG.gauge("sentinel_some_gauge", "h", labels={"a": "b"})
            (x or REG).histogram("sentinel_lat_ms", "h")
            REG.counter("sentinel_BadName_total", "h")
            REG.counter(dynamic_name, "not a literal — skipped")
            other.counter("not_sentinel_prefixed")
            """
        )
    )
    found = scan_registered_metrics(str(pkg))
    assert found == REF.scan_registered_metrics(str(pkg))
    assert set(found) == {"sentinel_good_total", "sentinel_some_gauge", "sentinel_lat_ms", "sentinel_BadName_total"}
    assert found["sentinel_good_total"][0][1] == 1


def test_check_flags_all_three_problem_classes(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "m.py").write_text(
        'REG.counter("sentinel_undocumented_total", "h")\n'
        'REG.gauge("sentinel_CamelCase", "h")\n'
        'REG.counter("sentinel_documented_total", "h")\n'
    )
    readme = tmp_path / "README.md"
    readme.write_text(
        "| metric | type | labels | meaning |\n"
        "|---|---|---|---|\n"
        "| `sentinel_documented_total` | counter | — | fine |\n"
        "| `sentinel_CamelCase` | gauge | — | documented but mis-named |\n"
        "| `sentinel_stale_row_total` | counter | — | no longer registered |\n"
    )
    problems = check_catalog(str(pkg), str(readme))
    assert problems == REF.check_catalog(str(pkg), str(readme))
    text = "\n".join(problems)
    assert "sentinel_undocumented_total" in text and "missing from" in text
    assert "snake_case" in text and "sentinel_CamelCase" in text
    assert "sentinel_stale_row_total" in text and "stale" in text
    # a port-only metric cataloged in the port's own table is clean for the
    # port; the reference's lint does not read that table
    (pkg / "m.py").write_text('REG.counter("sentinel_port_only_total", "h")\n')
    readme.write_text("| plane | metric | type | meaning |\n|---|---|---|---|\n"
                      "| port | `sentinel_port_only_total` | counter | port-only |\n")
    assert check_catalog(str(pkg), str(readme)) == []
    assert any("missing from" in p for p in REF.check_catalog(str(pkg), str(readme)))


def test_readme_parser_reads_only_table_rows(tmp_path):
    readme = tmp_path / "README.md"
    readme.write_text(
        "prose mentioning `sentinel_not_a_row_total` inline\n"
        "| `sentinel_in_table_total` | counter | — | yes |\n"
        "  | `sentinel_indented_total` | gauge | — | yes |\n"
    )
    names = readme_catalog_names(str(readme))
    assert names == REF.readme_catalog_names(str(readme))
    assert names == ["sentinel_in_table_total", "sentinel_indented_total"]
