"""SARIF 2.1.0 output for repo scans (docs/scanning.md).

One run, one driver, one rule: every function whose vulnerability score
clears `scan.threshold` becomes a `result` whose primary location is the
function's line range (repo-relative uri against the SRCROOT base) and
whose `relatedLocations` carry the per-line attributions when the scan
ran with `scan.lines=true`. The mapping is the SARIF mirror of the
findings JSONL — same fields, viewer-ingestible shape (GitHub code
scanning, VS Code SARIF viewer).

`validate_sarif` is the lightweight structural checker the smoke and
tests gate on — the load-bearing subset of the 2.1.0 schema (version,
run/tool/driver shape, rule declaration, location/region sanity), not a
full JSON-Schema validation (no jsonschema dependency in the image).

The port's copy of the JAX package's `deepdfa_tpu/scan/sarif.py`.
"""

from __future__ import annotations

import json
from pathlib import Path

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)
RULE_ID = "DEEPDFA0001"


def sarif_report(
    findings: list[dict],
    repo_root: str | Path,
    threshold: float = 0.5,
    tool_version: str = "0",
) -> dict:
    """Findings (the JSONL rows) -> one SARIF 2.1.0 document."""
    results = []
    for f in findings:
        if not f.get("ok") or f.get("prob") is None:
            continue
        if f["prob"] < threshold:
            continue
        result = {
            "ruleId": RULE_ID,
            "level": "error" if f["prob"] >= 0.9 else "warning",
            "message": {
                "text": (
                    f"function `{f['function']}` scored "
                    f"{f['prob']:.4f} for vulnerability "
                    f"(threshold {threshold})"
                ),
            },
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": f["file"],
                        "uriBaseId": "SRCROOT",
                    },
                    "region": {
                        "startLine": int(f["start_line"]),
                        "endLine": int(f["end_line"]),
                    },
                },
            }],
            "properties": {
                "prob": f["prob"],
                "function": f["function"],
            },
        }
        lines = f.get("lines")
        if lines:
            result["relatedLocations"] = [
                {
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": f["file"],
                            "uriBaseId": "SRCROOT",
                        },
                        "region": {"startLine": int(la["line"])},
                    },
                    "message": {
                        "text": (
                            f"line attribution score "
                            f"{la['score']:.6f}"
                        ),
                    },
                }
                for la in lines
            ]
            result["properties"]["line_scores"] = lines
        results.append(result)
    root_uri = Path(repo_root).resolve().as_uri()
    if not root_uri.endswith("/"):
        root_uri += "/"
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": "deepdfa-tpu",
                    "informationUri":
                        "https://github.com/ISU-PAAL/DeepDFA",
                    "version": str(tool_version),
                    "rules": [{
                        "id": RULE_ID,
                        "name": "VulnerableFunction",
                        "shortDescription": {
                            "text": (
                                "Function classified vulnerable by the "
                                "DeepDFA abstract-dataflow GGNN"
                            ),
                        },
                        "defaultConfiguration": {"level": "warning"},
                    }],
                },
            },
            "originalUriBaseIds": {"SRCROOT": {"uri": root_uri}},
            "results": results,
        }],
    }


def validate_sarif(doc: dict) -> list[str]:
    """Structural problems in a SARIF document ([] = valid)."""
    bad: list[str] = []

    def need(cond: bool, msg: str) -> bool:
        if not cond:
            bad.append(msg)
        return cond

    if not need(isinstance(doc, dict), "document is not an object"):
        return bad
    need(doc.get("version") == SARIF_VERSION,
         f"version must be {SARIF_VERSION!r}, got {doc.get('version')!r}")
    need(isinstance(doc.get("$schema"), str), "$schema missing")
    runs = doc.get("runs")
    if not need(isinstance(runs, list) and len(runs) >= 1,
                "runs must be a non-empty list"):
        return bad
    for ri, run in enumerate(runs):
        driver = (run.get("tool") or {}).get("driver") or {}
        need(isinstance(driver.get("name"), str) and driver["name"],
             f"runs[{ri}].tool.driver.name missing")
        rule_ids = {
            r.get("id") for r in driver.get("rules", [])
            if isinstance(r, dict)
        }
        results = run.get("results")
        if not need(isinstance(results, list),
                    f"runs[{ri}].results must be a list"):
            continue
        bases = run.get("originalUriBaseIds", {})
        for i, res in enumerate(results):
            where = f"runs[{ri}].results[{i}]"
            need(isinstance(((res.get("message") or {}).get("text")), str),
                 f"{where}.message.text missing")
            rid = res.get("ruleId")
            need(rid in rule_ids,
                 f"{where}.ruleId {rid!r} not declared in driver.rules")
            locs = res.get("locations")
            if not need(isinstance(locs, list) and locs,
                        f"{where}.locations must be non-empty"):
                continue
            for loc in locs + res.get("relatedLocations", []):
                phys = loc.get("physicalLocation") or {}
                art = phys.get("artifactLocation") or {}
                uri = art.get("uri")
                need(isinstance(uri, str) and uri and not uri.startswith("/"),
                     f"{where}: artifactLocation.uri must be relative")
                base = art.get("uriBaseId")
                if base is not None:
                    need(base in bases,
                         f"{where}: uriBaseId {base!r} not declared")
                region = phys.get("region") or {}
                start = region.get("startLine")
                need(isinstance(start, int) and start >= 1,
                     f"{where}: region.startLine must be an int >= 1")
                end = region.get("endLine", start)
                need(isinstance(end, int) and end >= start,
                     f"{where}: region.endLine must be >= startLine")
    return bad


def write_sarif(doc: dict, path: str | Path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=1))
    return path
