"""A CPU stand-in for the card, so the CPU tests can drive harness.run
past the look for a card, and a cell cut to a size the CPU solves in a
test's time. `small_runs(harness)` puts both in place."""

N_SMALL = 4096


class CpuCard:
    platform = "cpu"
    device = "cpu"

    def sync(self):
        pass

    def kind(self) -> str:
        return "cpu"

    def peak_bytes(self) -> int:
        return 0

    def free(self):
        pass

    def activities(self) -> list:
        import torch

        return [torch.profiler.ProfilerActivity.CPU]


def small_runs(harness, setattr_=setattr):
    """Make `harness` run on the CPU with every cell's LPs at N_SMALL
    rows and columns. `setattr_` is monkeypatch.setattr in a test, so
    the change is undone after it."""
    cell = harness.cell

    def small_cell(manifest, workload):
        c = cell(manifest, workload)
        c["config"]["generator"].update(n_rows=N_SMALL, n_cols=N_SMALL)
        return c

    setattr_(harness, "CARD", CpuCard())
    setattr_(harness, "cell", small_cell)
