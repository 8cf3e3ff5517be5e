"""`cuopt_sh` thin-client CLI, mirroring the reference
python/cuopt_self_hosted/cuopt_sh_client/cuopt_sh.py:329: submit a JSON
problem file to a running solver service, poll, print the result
(counterpart of cuopt_tpu/clients/cuopt_sh.py).

Usage: python -m cuopt_torch.clients.cuopt_sh data.json [-i IP] [-p PORT]
       [-t lp|routing] [-d reqId] [-s]
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cuopt_sh")
    p.add_argument("data", nargs="?", help="JSON problem file")
    p.add_argument("-i", "--ip", default="0.0.0.0")
    p.add_argument("-p", "--port", type=int, default=5000)
    p.add_argument("-s", "--ssl", action="store_true")
    p.add_argument(
        "-t", "--type", choices=("lp", "routing"), default=None,
        help="problem type (autodetected from the payload by default)",
    )
    p.add_argument(
        "-d", "--delete", default=None, metavar="REQID",
        help="abort/delete a queued or running request",
    )
    p.add_argument("--poll-interval", type=float, default=1.0)
    p.add_argument("--health", action="store_true")
    args = p.parse_args(argv)

    from cuopt_torch.clients.self_hosted import CuOptServiceSelfHostClient

    client = CuOptServiceSelfHostClient(
        ip=args.ip, port=args.port, use_https=args.ssl,
        polling_interval=args.poll_interval,
    )
    if args.health:
        print(json.dumps(client.health()))
        return 0
    if args.delete:
        print(json.dumps(client.delete(args.delete)))
        return 0
    if not args.data:
        p.error("a JSON problem file is required")
    try:
        with open(args.data) as f:
            payload = json.load(f)
    except OSError as exc:
        print(f"cuopt_sh: cannot read {args.data}: {exc}", file=sys.stderr)
        return 2
    except json.JSONDecodeError as exc:
        print(f"cuopt_sh: invalid JSON in {args.data}: {exc}",
              file=sys.stderr)
        return 2
    if args.type == "lp" or "csr_constraint_matrix" in payload:
        result = client.get_LP_solve(payload)
    else:
        result = client.get_optimized_routes(payload)
    print(json.dumps(result, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
