"""Run the solver service: python -m cuopt_torch.server [--port P]
(reference `cuopt_server`/cuopt_service.py entry; counterpart of
cuopt_tpu/server/__main__.py). The workers solve on the card unless
CUOPT_TORCH_DEVICE says "cpu"."""

import argparse


def main():
    p = argparse.ArgumentParser(prog="cuopt_torch.server")
    p.add_argument("-p", "--port", type=int, default=5000)
    p.add_argument("-i", "--ip", default="0.0.0.0")
    p.add_argument(
        "-d", "--device-count", type=int, default=None,
        help="solver processes, one per GPU (reference --gpu-count; "
        "default CUOPT_GPU_COUNT, else 1)",
    )
    args = p.parse_args()
    from cuopt_torch.server.webserver import run

    run(host=args.ip, port=args.port, n_workers=args.device_count)


if __name__ == "__main__":
    main()
