"""Dataset evaluation driver (port of pope_tpu/eval/evaluate.py; the
eval_*_json.py / acc1-30_*.py equivalent).

Reference behavior: eval_linemod_json.py:41-188 — per-object metric dicts,
GT relative pose = pose1 @ inv(pose0) (:137-143), AP50 recall of the chosen
box vs the projected 3-D bbox rectangle (:152-159), per-pair
relative_pose_error with a 90-degree penalty when the solver fails
(:163-168), tabulate per-object table with an Avg row (:183-188), and the
acc1-30_* variants' xlsx export (acc1-30_onepose.py:184-189).
"""

from __future__ import annotations

import os
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from pope_tpu_torch.data.loader import ThreadedLoader
from pope_tpu_torch.eval.manifest import DATASETS, iter_pairs, load_manifest
from pope_tpu_torch.pipeline import runner
from pope_tpu_torch.utils.metrics import aggregate_metrics, recall_object


def evaluate_pairs(
    pair_results: Iterable[dict],
    failure_penalty_deg: float = 90.0,
) -> Dict[str, dict]:
    """Aggregate a stream of per-pair records into per-object metric tables.

    Each record: {object, identifier, ok, R_err, t_err, pre_bbox, gt_bbox}.
    Returns {object: {metrics..., 'AP50': recall}}.
    """
    per_obj: Dict[str, dict] = {}
    for rec in pair_results:
        obj = rec["object"]
        m = per_obj.setdefault(
            obj,
            {"R_errs": [], "t_errs": [], "epi_errs": [], "identifiers": [], "recalled": 0, "total": 0,
             "dropped_masks": 0, "dropped_matches": 0},
        )
        m["total"] += 1
        # capacity-saturation telemetry: totals of candidates/matches the
        # static capacities truncated ("no silent caps")
        m["dropped_masks"] += int(rec.get("n_dropped_masks") or 0)
        m["dropped_matches"] += int(rec.get("n_dropped_matches") or 0)
        if rec.get("epi_errs") is not None:
            m["epi_errs"].append(np.asarray(rec["epi_errs"]))
        if rec.get("pre_bbox") is not None and rec.get("gt_bbox") is not None:
            iou = recall_object(rec["pre_bbox"], rec["gt_bbox"])
            m["recalled"] += int(iou > 0.5)
        if rec["ok"]:
            m["R_errs"].append(float(rec["R_err"]))
            m["t_errs"].append(float(rec["t_err"]))
        else:
            m["R_errs"].append(failure_penalty_deg)
            m["t_errs"].append(failure_penalty_deg)
        m["identifiers"].append(rec["identifier"])

    out = {}
    for obj, m in per_obj.items():
        agg = aggregate_metrics(m)
        agg["AP50"] = m["recalled"] / max(m["total"], 1)
        # mean truncation per pair; 0.0 everywhere unless a capacity
        # saturated, in which case the table/xlsx make it visible
        agg["maskDrop"] = m["dropped_masks"] / max(m["total"], 1)
        agg["matchDrop"] = m["dropped_matches"] / max(m["total"], 1)
        out[obj] = agg
    return out


def results_table(per_object: Dict[str, dict]) -> str:
    """fancy-grid table with an Avg row (eval_linemod_json.py:183-188)."""
    from tabulate import tabulate

    objs = list(per_object)
    headers = ["Category"] + list(per_object[objs[0]].keys())
    rows = [[obj] + list(per_object[obj].values()) for obj in objs]
    avg = np.asarray([r[1:] for r in rows], np.float64).mean(0)
    rows.append(["Avg"] + avg.tolist())
    return tabulate(rows, headers=headers, tablefmt="fancy_grid")


def _write_minimal_xlsx(path: str, headers: List[str], rows: List[list]):
    """Hand-rolled single-sheet xlsx (a zip of XML) — no openpyxl in the
    runtime image. Readable by pandas/Excel/LibreOffice."""
    import zipfile
    from xml.sax.saxutils import escape

    def cell(v):
        if isinstance(v, (int, float, np.floating, np.integer)):
            return f"<c t=\"n\"><v>{v}</v></c>"
        return f"<c t=\"inlineStr\"><is><t>{escape(str(v))}</t></is></c>"

    sheet_rows = "".join(
        "<row>" + "".join(cell(v) for v in row) + "</row>"
        for row in [headers] + rows
    )
    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
        f"<sheetData>{sheet_rows}</sheetData></worksheet>"
    )
    content_types = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
        '<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
        '<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
        "</Types>"
    )
    rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>'
        "</Relationships>"
    )
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
        'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
        '<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets></workbook>'
    )
    wb_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>'
        "</Relationships>"
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", content_types)
        z.writestr("_rels/.rels", rels)
        z.writestr("xl/workbook.xml", workbook)
        z.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        z.writestr("xl/worksheets/sheet1.xml", sheet)


def results_to_xlsx(per_object: Dict[str, dict], path: str, decimals: int = 3):
    """acc1-30_* style xlsx export with rounded values (to_excel.py)."""
    objs = list(per_object)
    headers = ["Category"] + list(per_object[objs[0]].keys())
    rows = [[obj] + [round(v, decimals) for v in per_object[obj].values()] for obj in objs]
    avg = np.asarray([r[1:] for r in rows], np.float64).mean(0)
    rows.append(["Avg"] + [round(float(v), decimals) for v in avg])
    _write_minimal_xlsx(path, headers, rows)
    return rows


def evaluate_dataset(
    models,
    dataset: str,
    data_root: str,
    pairs_dir: str,
    run_pair: Optional[Callable] = None,
    max_pairs: Optional[int] = None,
    progress: bool = True,
    batch_size: Optional[int] = None,
    run_pairs: Optional[Callable] = None,
    mesh=None,
    on_batch: Optional[Callable] = None,
) -> Dict[str, dict]:
    """Run the full pipeline over a dataset's pair manifest, on the device
    the models were loaded on (`load_models` defaults to CUDA).

    Batched mode (`batch_size=B`, the production path and the `eval` CLI's
    default): chunks the manifest into B-pair batches (the last one ragged)
    and calls `run_pairs(models, paths_list, spec) -> [records]`
    (pipeline.runner.run_pairs by default), with host IO and uploads
    prefetched by a loader thread. With the default runner, up to
    POPE_PIPELINE_DEPTH (default 2) batches are queued on the device before
    the oldest one's records are built, and `on_batch(n_records)` fires
    after each batch's records land. `mesh`: optional dp mesh: each rank
    runs its B / dp pairs of every batch and the records gather to dp rank
    0 (B must divide by dp; a ragged final batch is padded to the dp
    multiple with its last pair and the pad records dropped). Rank 0
    returns the tables; the other ranks return {}.

    Serial mode (`run_pair(models, paths, spec) -> record`): the reference's
    per-pair loop shape (eval_linemod_json.py:51), kept for `--serial`.
    """
    spec = DATASETS[dataset]
    manifest = load_manifest(pairs_dir, spec)
    records: List[dict] = []
    n = 0

    if batch_size:
        pipelined = run_pairs is None  # custom runners sync batch by batch
        dp = 1
        if mesh is not None:
            from pope_tpu_torch.parallel.mesh import axis_size

            dp = axis_size(mesh, "dp")
            progress = progress and mesh.get_rank() == 0
        if batch_size % dp:
            raise ValueError(f"batch_size {batch_size} not divisible by dp={dp}")

        def gen_batches():
            # path chunks only; decode + upload happen in the loader
            # thread(s) via `prep` below, so that disk IO and uploads overlap
            # device compute
            chunk = []
            produced = 0
            for paths in iter_pairs(data_root, spec, manifest):
                if max_pairs is not None and produced >= max_pairs:
                    break
                chunk.append(paths)
                produced += 1
                if len(chunk) == batch_size:
                    yield len(chunk), chunk
                    chunk = []
            if chunk:
                n_real = len(chunk)
                while len(chunk) % dp:  # pad a ragged tail to the dp multiple
                    chunk = chunk + [chunk[-1]]
                yield n_real, chunk

        def prep(item):
            n_real, chunk = item
            return (n_real, chunk, *runner.prepare_batch(chunk, models.device, mesh))

        # software-pipeline across batches with the default runner: keep up
        # to `depth` batches queued on the device before fetching the oldest
        # one, so that the device does not drain while the host fetches
        # results, builds records and dispatches again
        depth = max(1, int(os.environ.get("POPE_PIPELINE_DEPTH", "2")))
        n_workers = int(os.environ.get("POPE_LOADER_WORKERS", "1"))
        pending = deque()

        def drain_one():
            p, n_real = pending.popleft()
            records.extend(runner.finish_pairs(p)[:n_real])
            if on_batch is not None:
                on_batch(len(records))

        for n_real, chunk, hosts, dev in ThreadedLoader(gen_batches, num_workers=n_workers, prefetch=2, fn=prep):
            if pipelined:
                pending.append((runner.dispatch_pairs(models, chunk, spec, hosts=hosts, dev=dev, mesh=mesh), n_real))
                if len(pending) > depth:
                    drain_one()
            else:
                # custom runners (tests) may not take a mesh
                kw = {"mesh": mesh} if mesh is not None else {}
                records.extend(run_pairs(models, chunk, spec, hosts=hosts, dev=dev, **kw)[:n_real])
            prev_n, n = n, n + n_real
            # fire once whenever a multiple of 50 is crossed (batch sizes
            # >= 50 would otherwise print every batch)
            if progress and (n // 50 > prev_n // 50):
                print(f"[{dataset}] {n} pairs")
        while pending:
            drain_one()
        return evaluate_pairs(records)

    if run_pair is None:
        run_pair = runner.run_pair
    for paths in iter_pairs(data_root, spec, manifest):
        if max_pairs is not None and n >= max_pairs:
            break
        records.append(run_pair(models, paths, spec))
        n += 1
        if progress and n % 50 == 0:
            print(f"[{dataset}] {n} pairs")
    return evaluate_pairs(records)
