"""Quickstart: auction-based clustered federated learning in ~40 lines,
on the PyTorch port (``examples/quickstart.py`` with ``repro_torch``).

Runs the paper's full pipeline (gradient clustering -> per-cluster auction
-> FedAvg) with 30 edge clients on a synthetic non-IID MNIST-like dataset.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

from repro_torch.configs.base import FLConfig
from repro_torch.core.adapters import cnn_adapter
from repro_torch.core.server import FederatedServer
from repro_torch.data.partition import partition_clients
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.launch.train import set_float32_precision


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    set_float32_precision()

    cfg = FLConfig(
        num_clients=30,                 # N edge clients
        num_clusters=5,                 # J gradient clusters
        select_ratio=0.2,               # K/N selected per round
        rounds=15,
        non_iid_level=1.0,              # nu = 1: fully non-IID
        scheme="gradient_cluster_auction",
        init_energy_mode="normal",      # case 2: heterogeneous batteries
    )
    train, test = make_image_dataset("mnist", n_train=4000, n_test=800,
                                     device=args.device)
    clients = partition_clients(train.y, cfg, seed=0)
    print(f"{cfg.num_clients} clients, local sizes "
          f"{min(c.size for c in clients)}..{max(c.size for c in clients)}")

    server = FederatedServer(cfg, cnn_adapter("mnist", args.device), train.x,
                             train.y, clients, {"x": test.x, "y": test.y},
                             device=args.device)
    logs = server.run(verbose=True)

    print("\ncluster assignment of the 30 clients (primary label = i % 10):")
    print(server.state.clusters.cpu().numpy().reshape(3, 10))
    print(f"\nfinal test accuracy : {logs[-1].test_acc:.3f}")
    print(f"energy-balance std  : {logs[-1].energy_std:.3f}")
    print(f"mean winning bid    : {logs[-1].mean_bid:.3f}")


if __name__ == "__main__":
    main()
