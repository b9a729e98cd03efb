"""Simulator-host RPC server of the port:
`python -m manigaussian_tpu_torch.sim_host_server`.

The counterpart of the JAX package's `scripts/sim_host_server.py`, with its
flags: it runs an EnvClient (RLBench/CoppeliaSim, the mock, or a recorded
transcript) behind the TCP protocol of `envs/rpc.py`, so a GPU host
evaluates against it with `python -m manigaussian_tpu_torch.eval --env
rpc://HOST:PORT` (the JAX eval's `--env rpc://` talks to it too). It serves
the port's envs, so a deployment of the port needs nothing of the JAX
package. It uses no GPU.

The first line of its output is `[sim-host] serving <backend> env on
HOST:PORT`, the port that was bound: `--port 0` binds a free one.

On the sim host, with CoppeliaSim and RLBench installed:
    python -m manigaussian_tpu_torch.sim_host_server --port 18861 \
        --backend rlbench --dataset-root /data/demos --cameras front

Without a simulator (serves the stored episodes), recording the session:
    python -m manigaussian_tpu_torch.sim_host_server --port 18861 \
        --backend mock --dataset-root /tmp/demos --record /tmp/session.jsonl
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=18861)
    parser.add_argument("--backend", default="rlbench",
                        choices=["rlbench", "mock", "transcript"])
    parser.add_argument("--dataset-root", default=None,
                        help="demo root (rlbench/mock) — required unless "
                             "--backend transcript")
    parser.add_argument("--transcript", default=None,
                        help="recorded session JSONL to replay "
                             "(--backend transcript), see envs/transcript.py")
    parser.add_argument("--record", default=None,
                        help="record this session's call/response transcript "
                             "to the given JSONL path (any backend)")
    parser.add_argument("--cameras", nargs="+", default=["front"])
    parser.add_argument("--image-size", type=int, default=128)
    parser.add_argument("--episode-length", type=int, default=25)
    parser.add_argument("--headless", action="store_true", default=True)
    args = parser.parse_args(argv)

    if args.backend == "transcript":
        if not args.transcript:
            parser.error("--backend transcript needs --transcript")
        from manigaussian_tpu_torch.envs.transcript import TranscriptReplayEnv
        env = TranscriptReplayEnv(args.transcript)
    elif args.backend == "rlbench":
        if not args.dataset_root:
            parser.error("--backend rlbench needs --dataset-root")
        from manigaussian_tpu_torch.envs.rlbench_env import RLBenchEnvClient
        env = RLBenchEnvClient(args.dataset_root, cameras=args.cameras,
                               image_size=(args.image_size, args.image_size),
                               episode_length=args.episode_length,
                               headless=args.headless)
    else:
        if not args.dataset_root:
            parser.error("--backend mock needs --dataset-root")
        from manigaussian_tpu_torch.envs.mock_env import MockEnvClient
        env = MockEnvClient(args.dataset_root, cameras=tuple(args.cameras),
                            episode_length=args.episode_length)

    if args.record:
        from manigaussian_tpu_torch.envs.transcript import TranscriptRecorder
        env = TranscriptRecorder(env, args.record)

    from manigaussian_tpu_torch.envs.rpc import EnvRPCServer
    server = EnvRPCServer(env, host=args.host, port=args.port)
    print(f"[sim-host] serving {args.backend} env on "
          f"{args.host}:{server.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
