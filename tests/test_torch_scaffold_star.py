"""The port's run_full against the reference's on the star-gap fixture
(tests/test_star_gap_pipeline.py: 8 kb molecules on a 30 kb haploid genome
with a sequencing void that only barcodes bridge), which takes the fifteen
scaffold phases: every phase's <phase>/a.sup.npz snapshot, scaffold_mode
"star-gap" and the outputs of tests/test_torch_scaffold.py, all exactly
equal.  Then the re-entry: a resumed run from the fase snapshot runs no
phase; a run stopped by SN_STOP_AFTER_PHASE=star and resumed equals the
uninterrupted run; the port resumes a reference outdir stopped after star
to the reference's outputs.  Also asm/local.py's unvoid and unvoid_voids,
which the stage calls, against the reference's on the stage's own D."""
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from supernova_tpu.align import index as rindex
from supernova_tpu.asm import lines as ralines
from supernova_tpu.asm import local as rlocal
from supernova_tpu.asm import misassembly as rmis
from supernova_tpu.asm import scaffold as rscaffold
from supernova_tpu.ingest.ingest import ingest_sim
from supernova_tpu.pipeline import run as rrun
from supernova_tpu.sim import genome as sim
from supernova_tpu_torch.align import index as pindex
from supernova_tpu_torch.asm import lines as plines
from supernova_tpu_torch.asm import local as plocal
from supernova_tpu_torch.asm import misassembly as pmis
from supernova_tpu_torch.asm import molecules as pmol
from supernova_tpu_torch.asm import supergraph as psg
from supernova_tpu_torch.asm.lines import Cell, Line
from supernova_tpu_torch.asm import scaffold as pscaffold
from supernova_tpu_torch.pipeline import datasets
from supernova_tpu_torch.pipeline import run as prun

from tests.test_star_gap_pipeline import _mask_window
from tests.test_torch_scaffold import OUTPUTS, assert_outputs_equal, gz_bytes, to_plain
from tests.test_torch_slice import assert_npz_equal

OPTS = dict(auto_downsample=False)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def star_gap_reads():
    rng = np.random.default_rng(0)
    g = sim.random_genome(rng, 30_000)
    wl = sim.make_whitelist(rng, 256)
    reads = sim.simulate_linked_reads(
        rng, (g, g), wl, n_barcodes=80, molecules_per_barcode=2, molecule_len=8_000,
        coverage_per_molecule=1.0, error_rate=0.0,
    )
    return _mask_window(reads, 14_500, 15_000), wl


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rs = ingest_sim(*star_gap_reads())
    ref_out, port_out = tmp_path_factory.mktemp("ref"), tmp_path_factory.mktemp("port")
    ref = rrun.Pipeline(ref_out, **OPTS)
    ref_res = ref.run_full(rs)
    port = prun.Pipeline(port_out, device="cpu", **OPTS)
    port_res = port.run_full(rs)
    return rs, (ref_out, ref, ref_res), (port_out, port, port_res)


def stopped_after(pipeline, rs, monkeypatch, phase="star"):
    """run_full under SN_STOP_AFTER_PHASE=phase: it exits after that
    phase's snapshot."""
    monkeypatch.setenv("SN_STOP_AFTER_PHASE", phase)
    with pytest.raises(SystemExit) as e:
        pipeline.run_full(rs)
    monkeypatch.delenv("SN_STOP_AFTER_PHASE")
    assert e.value.code == 0


def assert_snapshots_equal(want, got, phases=prun.Pipeline.SUP_PHASES):
    for name in phases:
        assert_npz_equal(want / name / "a.sup.npz", got / name / "a.sup.npz")


def test_recipe_is_the_fixture():
    """datasets.star_gap_reads (the port's simulator and mask) makes the
    fixture's reads, which chip_smoke.py runs through run_full on the card."""
    want, wl_r = star_gap_reads()
    got, wl_p = datasets.star_gap_reads(np.random.default_rng(0))
    assert np.array_equal(wl_r, wl_p) and datasets.SMALL_RUNS["star-gap"][1] == OPTS
    for f in ("r1", "q1", "r2", "q2", "barcode", "bc_qual", "truth_pos", "truth_hap"):
        assert np.array_equal(np.asarray(getattr(want, f)), np.asarray(getattr(got, f))), f


def test_phase_snapshots_match_reference(runs):
    """All fifteen <phase>/a.sup.npz: D, placements, read and base-edge
    counts and the join count after each phase."""
    _, (ref_out, ref, _), (port_out, port, _) = runs
    assert prun.Pipeline.SUP_PHASES == rrun.Pipeline.SUP_PHASES
    assert_snapshots_equal(ref_out, port_out)
    assert ref.stats.get("scaffold_mode") == port.stats.get("scaffold_mode") == "star-gap"
    assert port.stats.get("star_gap_joins") >= 1
    assert list(port.stage_records["scaffold"]["phase_s"]) == list(prun.Pipeline.SUP_PHASES)


def test_outputs_match_reference(runs):
    _, (ref_out, _, ref_res), (port_out, _, port_res) = runs
    assert_outputs_equal(ref_out, port_out)
    assert to_plain(port_res[:4]) == to_plain(ref_res[:4])


def test_resume_from_the_fase_snapshot_runs_no_phase(runs, tmp_path):
    """tests/test_pipeline_e2e.py's re-entry test on the port: the early
    phases poisoned, a resumed run re-enters after fase and writes the same
    FASTA bytes."""
    rs, _, (port_out, _, port_res) = runs
    out = tmp_path / "asm"
    shutil.copytree(port_out, out)
    pl = prun.Pipeline(out, device="cpu", resume=True, **OPTS)
    pl._star_multipass = pl._barcode_join_passes = pl._fix_misassemblies = None
    res = pl.run_full(rs)
    assert pl.stage_records["scaffold"]["phase_s"] == {}
    for name in OUTPUTS[:4]:
        assert gz_bytes(out / name) == gz_bytes(port_out / name), name
    assert len(res[2]) == len(port_res[2]) and res[0].n_edges == port_res[0].n_edges


def test_stopped_after_star_then_resumed_equals_the_whole_run(runs, tmp_path, monkeypatch):
    rs, _, (port_out, *_) = runs
    out = tmp_path / "asm"
    stopped_after(prun.Pipeline(out, device="cpu", **OPTS), rs, monkeypatch)
    assert (out / "star" / "a.sup.npz").exists() and not (out / "fix").exists()
    pl = prun.Pipeline(out, device="cpu", resume=True, **OPTS)
    pl.run_full(rs)
    assert list(pl.stage_records["scaffold"]["phase_s"]) == list(prun.Pipeline.SUP_PHASES[2:])
    assert_snapshots_equal(port_out, out)
    assert_outputs_equal(port_out, out, glue=False, resumed=True)


def test_port_resumes_a_reference_outdir_stopped_after_star(runs, tmp_path, monkeypatch):
    """State carried across packages: the reference's checkpoints and its
    star snapshot, resumed by the port, give the reference's full run."""
    rs, (ref_out, *_), _ = runs
    stopped = tmp_path / "stopped"
    stopped_after(rrun.Pipeline(stopped, **OPTS), rs, monkeypatch)
    out, ref_resumed = tmp_path / "port", tmp_path / "ref"
    shutil.copytree(stopped, out)
    shutil.copytree(stopped, ref_resumed)
    pl = prun.Pipeline(out, device="cpu", resume=True, **OPTS)
    pl.run_full(rs)
    rrun.Pipeline(ref_resumed, resume=True, **OPTS).run_full(rs)
    assert list(pl.stage_records["scaffold"]["phase_s"]) == list(prun.Pipeline.SUP_PHASES[2:])
    assert_snapshots_equal(ref_out, out)
    assert_outputs_equal(ref_out, out, glue=False, resumed=True)
    assert_outputs_equal(ref_resumed, out, glue=False)


def test_unvoid_and_unvoid_voids_match_reference(runs):
    """asm/local.py's unvoid and unvoid_voids, once each, on the D that the
    stackaroo phase left (its snapshot, loaded by each package), with each
    package's fill-ownership context and line evidence."""
    rs, (ref_out, ref, ref_res), (port_out, port, port_res) = runs
    got = {}
    for name, pl, out, bg, idx, lines_mod, local, sc in (
            ("ref", ref, ref_out, ref_res[0].bg, rindex, ralines, rlocal, rscaffold),
            ("port", port, port_out, port_res[0].bg, pindex, plines, plocal, pscaffold)):
        snap = out / "stackaroo" / "a.sup.npz"
        D, pl._dpaths, pl._dlen = pl._load_sup_snapshot(bg, snap, want_paths=True)
        lines = lines_mod.find_lines(D)
        pl._refresh_positions(D, lines, rs)
        edges, plen = pl._base_paths[:2]
        ebcx = idx.edge_barcodes(edges, plen, rs.bc, D.bg.n_edges)
        D2, n = local.unvoid(D, rs, ebcx, ownership=pl._fill_ownership(D, lines))
        llens, _, line_bcs, _ = pl._line_evidence(D, lines, rs, ebcx, sc.good_barcodes(rs.bc))
        D3, n_voids = local.unvoid_voids(D, rs, ebcx, lines, line_bcs, llens,
                                         ownership=pl._fill_ownership(D, lines))
        got[name] = to_plain((D2.epaths, D2.dinv, D2.from_v, D2.to_v, n,
                              D3.epaths, D3.dinv, D3.from_v, D3.to_v, n_voids))
    assert got["port"] == got["ref"]



class CellGraph:
    """The part of a SuperGraph that kill_misassembled_cells reads without
    its repeat rule: D-edges of given lengths, one base edge each or a
    {-2, size} gap row."""

    def __init__(self, lens, gaps):
        self.lens = lens
        self.n_edges = len(lens)
        rows = [[-2, int(lens[d])] if d in gaps else [d] for d in range(len(lens))]
        self.epaths = psg.Ragged.from_rows(rows, dtype=np.int64)

    def edge_len(self, d):
        return int(self.lens[d])

    def is_gap(self, d):
        return int(self.epaths.row(d)[0]) < 0

    def gap_mask(self):
        return np.array([self.is_gap(d) for d in range(self.n_edges)])


def cell_lines(rng, n_bcs, n_pos, n_lines=3, n_cells=90):
    """Lines of straight cells with bubble and gap cells between them, and
    barcodes on 10-60 kb molecules along each line, with the barcodes that
    span some junctions cut there (weak junctions), and positions on the
    windows' edges (cell mid +- each tier's flank and dead zone, +- 1)."""
    lens, gaps, line_list = [], set(), []
    for _ in range(n_lines):
        cells = []
        for j in range(n_cells):
            kind = rng.integers(0, 3) if j % 2 else 0
            d = len(lens)
            if kind == 0:
                lens.append(int(rng.integers(800, 3_000)))
                cells.append(Cell([np.array([d])]))
            elif kind == 1:
                lens.extend(int(x) for x in rng.integers(95, 400, 2))
                cells.append(Cell([np.array([d]), np.array([d + 1])]))
            else:
                lens.append(int(rng.integers(100, 900)))
                gaps.add(d)
                cells.append(Cell([np.array([d])]))
        line_list.append(Line(cells))
    D = CellGraph(np.array(lens), gaps)
    lp = {}
    for li, line in enumerate(line_list):
        offs = pmol.element_offsets(D, line)
        cuts = rng.choice(offs[1:-1], len(offs) // 6)
        mids = np.array([offs[j] + (offs[j + 1] - offs[j]) // 2 for j in range(len(offs) - 1)])
        shifts = np.array([s_ * w + e for t in rmis.ESCALATION_TIERS for w in t[1:]
                           for s_ in (-1, 1) for e in (-1, 0, 1)] + [-1_000, 1_000])
        bcs = {}
        for b in range(1, n_bcs):
            s0 = int(rng.integers(-20_000, offs[-1]))
            ps = rng.integers(s0, s0 + int(rng.integers(10_000, 60_000)), n_pos)
            edge = rng.choice(mids, 4)[:, None] + rng.choice(shifts, (4, 3))
            ps = np.sort(np.concatenate([ps, edge.ravel()]))
            ps = ps[(ps >= 0) & (ps < offs[-1])]
            for c in cuts:
                if rng.random() < 0.8:
                    ps = ps[(ps < c) | (ps > c + 25_000)] if rng.random() < 0.5 else ps[ps > c]
            if len(ps):
                bcs[b] = ps.tolist()
        lp[li] = bcs
    return D, SimpleNamespace(lines=line_list, n_lines=n_lines), lp


def test_kill_misassembled_cells_matches_reference(runs):
    """The port's kill_misassembled_cells (binary-searched windows) deletes
    the reference's D-edges (every position masked at every cell): on
    synthetic lines of bubble, gap and straight cells with cut barcodes,
    at every escalation tier, with and without the molecule-length dead
    zone; and on the fixture's final D, lines and positions with the
    repeat rule."""
    _, (_, ref, (D, lines, *_)), _ = runs
    rng = np.random.default_rng(3)
    n_dels = n_kept = 0
    for n_bcs, n_pos in ((40, 4), (120, 8), (400, 60)):
        Dc, lc, lp = cell_lines(rng, n_bcs, n_pos)
        llens = np.array([pmol.element_offsets(Dc, ln)[-1] for ln in lc.lines])
        for tier in rmis.ESCALATION_TIERS:
            for lw in (None, 4_000.0):
                kw = dict(llens=llens, bc_require=tier[0], bc_flank=tier[1],
                          bc_ignore=tier[2], lw_mol_len=lw, judge_repeats=False)
                want = rmis.kill_misassembled_cells(Dc, lc, lp, **kw)
                assert pmis.kill_misassembled_cells(Dc, lc, lp, **kw) == want, kw
                n_dels += len(want)
                n_kept += Dc.n_edges - len(want)
    assert n_dels > 0 and n_kept > 0
    for lw in (None, 4_000.0):
        want = rmis.kill_misassembled_cells(D, lines, ref._line_positions, lw_mol_len=lw)
        assert pmis.kill_misassembled_cells(D, lines, ref._line_positions, lw_mol_len=lw) == want


@pytest.mark.parametrize("edge", ["-flank", "-ignore", "+ignore", "+flank"])
def test_kill_misassembled_cells_window_edges(edge):
    """Each window's edges are inclusive in both packages: a gap cell
    bridged by exactly BC_MIN barcodes, one of which reaches the window only
    by a position on the edge (kept) or one base past it (the cell is
    deleted)."""
    flank, ignore = rmis.BC_FLANK, rmis.BC_IGNORE
    D = CellGraph(np.array([30_000, 500, 30_000]), {1})
    lines = SimpleNamespace(lines=[Line([Cell([np.array([d])]) for d in range(3)])], n_lines=1)
    mid = 30_000 + 500 // 2
    at, outward = {"-flank": (mid - flank, -1), "-ignore": (mid - ignore, 1),
                   "+ignore": (mid + ignore, -1), "+flank": (mid + flank, 1)}[edge]
    got = {}
    for name, pos in (("on", at), ("past", at + outward)):
        lp = {b: [mid - 10_000, mid + 10_000] for b in range(2, rmis.BC_MIN + 1)}
        lp[1] = [pos, mid + 10_000] if edge[0] == "-" else [mid - 10_000, pos]
        lp.update({b: [mid - 12_000 if b % 2 else mid + 12_000] for b in range(20, 30)})
        kw = dict(llens=np.array([60_500]), judge_repeats=False)
        want = rmis.kill_misassembled_cells(D, lines, {0: lp}, **kw)
        got[name] = pmis.kill_misassembled_cells(D, lines, {0: lp}, **kw)
        assert got[name] == want
    assert got == {"on": [], "past": [1]}
