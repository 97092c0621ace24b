"""Small cells of the benchmark that run on the CPU in seconds."""


def small_cell(workload: str, n_qubits: int = 6, n_seeds: int = 8,
               epochs: int = 4):
    """``workload`` with its limits, cut to a size the CPU runs in
    seconds (the eager engine: no kernel runs here)."""
    from harness import spec
    cell = spec.find_cell(workload)
    cell.config = dict(cell.config, n_qubits=n_qubits,
                       n_controls=2 * n_qubits)
    cell.traffic = dict(cell.traffic, n_seeds=min(n_seeds,
                                                  cell.traffic["n_seeds"]),
                        epochs_per_job=epochs,
                        check_members=min(8, n_seeds))
    return cell
