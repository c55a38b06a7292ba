"""Selection-scheme comparison matrix on the PyTorch port
(``examples/scheme_comparison.py`` with ``repro_torch``): train the
paper's CNN federatedly under every scheme in the control-plane registry
(repro_torch.core.schemes — paper auction, uniform random, FedCS
deadline-gating, long-term budgeted auction) x Non-IID level, and
compare convergence (test accuracy/loss) against the two fairness
axes the zoo trades off: residual-energy balance (the paper's Fig 9/10
energy std) and participation spread (history std).  The long-term
auction also prints its budget ledger.

  PYTHONPATH=src python examples/scheme_comparison_torch.py [--rounds 20]
  PYTHONPATH=src python examples/scheme_comparison_torch.py --nus 1.0 0.5
"""
import argparse

import numpy as np

from repro_torch.configs.base import FLConfig
from repro_torch.core.adapters import cnn_adapter
from repro_torch.core.schemes import scheme_names
from repro_torch.core.server import FederatedServer
from repro_torch.data.partition import partition_clients
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.launch.train import set_float32_precision


def run_cell(scheme_select, nu, rounds, train, test, device):
    cfg = FLConfig(num_clients=50, num_clusters=10, select_ratio=0.2,
                   rounds=rounds, non_iid_level=nu,
                   scheme="gradient_cluster_auction",
                   scheme_select=scheme_select,
                   init_energy_mode="normal", seed=1)
    clients = partition_clients(train.y, cfg, seed=1)
    srv = FederatedServer(cfg, cnn_adapter("mnist", device), train.x,
                          train.y, clients, {"x": test.x, "y": test.y},
                          device=device)
    logs = srv.run()
    hist = np.asarray([int(h) for h in srv._host_history])
    row = {
        "acc": logs[-1].test_acc,
        "loss": logs[-1].test_loss,
        "energy_std": logs[-1].energy_std,
        "fairness": float(np.std(hist)),
        "vds_gap": float(np.mean([l.vds_gap for l in logs])),
    }
    ss = srv.state.scheme_state
    if ss is not None:
        row["budget"] = (f"{float(ss.spent):.2f}"
                         f"/{cfg.total_reward:.0f}")
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--nus", type=float, nargs="+", default=[1.0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    set_float32_precision()

    train, test = make_image_dataset("mnist", n_train=6000, n_test=1000,
                                     device=args.device)
    print(f"{'scheme':18s} {'nu':>4s} {'acc':>6s} {'loss':>7s} "
          f"{'E_std':>7s} {'fair':>6s} {'vds_gap':>8s} {'budget':>12s}")
    for nu in args.nus:
        for scheme in scheme_names():
            r = run_cell(scheme, nu, args.rounds, train, test, args.device)
            print(f"{scheme:18s} {nu:4.1f} {r['acc']:6.3f} "
                  f"{r['loss']:7.3f} {r['energy_std']:7.3f} "
                  f"{r['fairness']:6.2f} {r['vds_gap']:8.3f} "
                  f"{r.get('budget', '-'):>12s}")


if __name__ == "__main__":
    main()
