"""The PyTorch port's crash-safe DP training service, the counterpart of
`examples/train_service.py`: start the daemon, kill it mid-step by
deterministic fault injection, resume, and show that the persistent
privacy ledger and the checkpoints survive with the budget enforced.

Three acts on the tiny arch (a minute on the CPU):

  1. launch the service with `--fault-at post-ledger-append:5`: the
     process os._exit()s the instant step 5's spend is on the ledger,
     before the update commits (the worst-ordered crash);
  2. relaunch with no fault: the service replays the ledger through the
     RDP accountant, restores the newest verified checkpoint (step 3),
     re-executes steps 3-5 without ledgering them again, and finishes the
     run bitwise as a run that never crashed;
  3. read the ledger back and print the epsilon after each step.

    PYTHONPATH=src python examples/torch_train_service.py --device cpu
"""
import argparse
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
SERVICE_ARGS = [
    "--arch", "tiny", "--steps", "10", "--batch", "8", "--seq", "32",
    "--docs", "64", "--sigma", "0.8", "--checkpoint-every", "3",
    "--budget-eps", "6.0", "--log-every", "2",
]


def launch(service_dir, device, extra=()):
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}/src" + (
        f":{env['PYTHONPATH']}" if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "repro_torch.launch.service",
           "--service-dir", service_dir, "--device", device] + \
        SERVICE_ARGS + list(extra)
    return subprocess.run(cmd, env=env).returncode


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--service-dir",
                    default=os.path.join(REPO, "build", "torch_service_demo"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    shutil.rmtree(args.service_dir, ignore_errors=True)

    from repro_torch.core.accounting import RdpAccountant
    from repro_torch.launch.service import EXIT_FAULT, PrivacyLedger

    print("=== act 1: service killed at post-ledger-append:5 ===")
    rc = launch(args.service_dir, args.device,
                ["--fault-at", "post-ledger-append:5"])
    if rc != EXIT_FAULT:
        raise SystemExit(f"expected fault exit {EXIT_FAULT}, got {rc}")
    print(f"(process died with exit code {rc}: the step-5 spend is on disk, "
          "the step-5 update is not)")

    print("\n=== act 2: resume; the ledger replayed, no double spend ===")
    rc = launch(args.service_dir, args.device)
    if rc != 0:
        raise SystemExit(f"resume failed with exit code {rc}")

    print("\n=== act 3: the ledger, replayed ===")
    records = PrivacyLedger(
        os.path.join(args.service_dir, "ledger.jsonl")).replay()
    acct = RdpAccountant()
    for rec in records:
        acct.spend(rec["q"], rec["sigma"])
        print(f"  step {rec['step']:2d}  q={rec['q']:.5f} "
              f"sigma={rec['sigma']:.4f}  eps={acct.epsilon(1e-5):.4f}")
    print(f"final spend: epsilon={acct.epsilon(1e-5):.4f} over "
          f"{acct.steps} ledgered steps (budget 6.0)")


if __name__ == "__main__":
    main()
