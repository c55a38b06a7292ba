"""Federated pretraining of a (reduced) registry transformer on the
PyTorch port (``examples/fl_pretrain_lm.py`` with ``repro_torch``) — the
paper's selection layer applied to an LLM workload: clients hold
topic-skewed token shards; gradient clustering groups clients by topic;
the auction balances energy across the fleet.

  PYTHONPATH=src python examples/fl_pretrain_lm_torch.py --arch qwen2-0.5b \
      [--device cpu]
"""
import argparse

from repro_torch.configs.base import FLConfig
from repro_torch.configs.registry import ARCH_IDS, get_smoke_config
from repro_torch.core.adapters import transformer_adapter
from repro_torch.core.server import FederatedServer
from repro_torch.data.partition import partition_clients
from repro_torch.data.synthetic import make_token_dataset
from repro_torch.launch.train import set_float32_precision


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCH_IDS)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    set_float32_precision()

    mcfg = get_smoke_config(args.arch)
    cfg = FLConfig(num_clients=20, num_clusters=5, select_ratio=0.25,
                   rounds=args.rounds, lr=0.1, non_iid_level=1.0,
                   scheme="gradient_cluster_auction", num_classes=10,
                   sample_window=8, cluster_resamples=2,
                   init_energy_mode="normal")
    toks, topics = make_token_dataset(num_topics=10, vocab=mcfg.vocab_size,
                                      seq_len=32, n=800, seed=0)
    clients = partition_clients(topics, cfg, seed=0)
    srv = FederatedServer(cfg, transformer_adapter(mcfg, args.device), toks,
                          topics, clients, {"x": toks[:64], "y": topics[:64]},
                          device=args.device)
    logs = srv.run(verbose=True)
    print(f"\n{mcfg.name}: LM loss {logs[0].test_loss:.3f} -> "
          f"{logs[-1].test_loss:.3f} over {args.rounds} FL rounds; "
          f"energy std {logs[-1].energy_std:.3f}")


if __name__ == "__main__":
    main()
