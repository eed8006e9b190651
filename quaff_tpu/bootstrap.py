"""Remote worker bootstrap: ssh-launched servers and elastic cloud workers.

Reimplements the reference's cluster control plane (src/qmodel.cpp:
1093-1239, src/aws.cpp): worker servers are launched over ssh with
keep-alives, the "# READY" stdout sentinel acknowledges startup, launches
are retried with exponential backoff + jitter, and workers are stopped
with a {"quit":1} message.  Elastic provisioning shells out to the `aws`
CLI exactly like the reference (run-instances with a base64 user-data
bootstrap, wait instance-status-ok, terminate on exit and on signals).

On GPU clusters none of this is the scale-out path — that is the device mesh
(parallel/) — but it preserves the reference's operational surface for
CPU-cluster deployments and loopback testing (tests use a stub ssh).
"""

from __future__ import annotations

import atexit
import base64
import json
import random
import signal
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

from .server import send_framed

READY_SENTINEL = "# READY"

# retry parameters (qmodel.h:43-71)
MAX_GENERIC_SSH_ATTEMPTS = 10
MAX_WORKER_SSH_ATTEMPTS = 20
MIN_RETRY_DELAY = 10.0
RETRY_DELAY_MULTIPLIER = 1.15
SERVER_ALIVE_INTERVAL = 15
SERVER_ALIVE_COUNT_MAX = 3


def retry_delay(attempts: int, min_seconds: float = MIN_RETRY_DELAY,
                multiplier: float = RETRY_DELAY_MULTIPLIER) -> float:
    """Uniform jitter in [min*mult^a, min*mult^(a+1)]
    (randomDelayBeforeRetry, qmodel.cpp:39-50)."""
    lo = min_seconds * multiplier ** attempts
    return random.uniform(lo, lo * multiplier)


@dataclass
class RemoteServerSpec:
    addr: str
    port: int
    threads: int = 1
    user: str = ""
    instance_id: str = ""  # non-empty for elastic cloud workers

    def __str__(self) -> str:
        prefix = f"{self.user}@" if self.user else ""
        suffix = "" if self.threads == 1 else f"-{self.port + self.threads - 1}"
        return f"{prefix}{self.addr}:{self.port}{suffix}"


@dataclass
class SshLauncher:
    """Builds and runs ssh commands (makeSshCommand, qmodel.cpp:1131-1144)."""

    ssh_path: str = "ssh"
    ssh_key: str = ""

    def command(self, spec: RemoteServerSpec, remote_cmd: str) -> List[str]:
        cmd = [self.ssh_path,
               "-o", f"ServerAliveInterval={SERVER_ALIVE_INTERVAL}",
               "-o", f"ServerAliveCountMax={SERVER_ALIVE_COUNT_MAX}"]
        if self.ssh_key:
            cmd += ["-i", self.ssh_key]
        target = f"{spec.user}@{spec.addr}" if spec.user else spec.addr
        cmd += [target, remote_cmd]
        return cmd


class RemoteServerHandle:
    """One launched worker process plus its readiness state."""

    def __init__(self, spec: RemoteServerSpec, proc: subprocess.Popen):
        self.spec = spec
        self.proc = proc
        self.ready = threading.Event()
        self._reader = threading.Thread(target=self._scan_stdout, daemon=True)
        self._reader.start()

    def _scan_stdout(self) -> None:
        try:
            for line in self.proc.stdout:
                if READY_SENTINEL in line.decode("latin-1", "replace"):
                    self.ready.set()
        except ValueError:
            pass

    def wait_ready(self, timeout: float) -> bool:
        return self.ready.wait(timeout)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()


class RemoteServerPool:
    """startRemoteServers / stopRemoteServers (qmodel.cpp:1093-1167)."""

    def __init__(self, launcher: Optional[SshLauncher] = None,
                 worker_command: str = "quaff-tpu",
                 max_attempts: int = MAX_WORKER_SSH_ATTEMPTS,
                 ready_timeout: float = 600.0,
                 min_retry_delay: float = MIN_RETRY_DELAY,
                 elastic: Optional["ElasticPool"] = None):
        self.launcher = launcher or SshLauncher()
        self.worker_command = worker_command
        self.max_attempts = max_attempts
        self.ready_timeout = ready_timeout
        self.min_retry_delay = min_retry_delay
        # cloud pool for instance reboot as failure recovery
        self.elastic = elastic
        self.handles: List[RemoteServerHandle] = []

    def server_command(self, spec: RemoteServerSpec, server_args: str) -> str:
        return (
            f"{self.worker_command} server {server_args} "
            f"-port {spec.port} -threads {spec.threads}"
        )

    def start(self, specs: List[RemoteServerSpec], server_args: str) -> List[tuple]:
        """Launch all workers, wait for READY; returns [(addr, port)] for
        every worker thread port."""
        remotes: List[tuple] = []
        for spec in specs:
            handle = self._start_one(spec, server_args)
            self.handles.append(handle)
            for p in range(spec.port, spec.port + spec.threads):
                remotes.append((spec.addr, p))
        return remotes

    def _start_one(self, spec: RemoteServerSpec, server_args: str) -> RemoteServerHandle:
        last = None
        for attempt in range(self.max_attempts):
            cmd = self.launcher.command(spec, self.server_command(spec, server_args))
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL
            )
            handle = RemoteServerHandle(spec, proc)
            if handle.wait_ready(self.ready_timeout):
                return handle
            handle.stop()
            last = RuntimeError(f"worker {spec} did not report READY")
            if self.elastic is not None and spec.instance_id:
                # failure recovery on a cloud worker: reboot the instance
                # before retrying the launch (execWithRetries partial-
                # success handling qmodel.cpp:1211-1218, AWS::reboot
                # aws.cpp:107-112)
                try:
                    self.elastic.reboot(spec.instance_id)
                except Exception:
                    pass
            time.sleep(
                retry_delay(attempt, min_seconds=self.min_retry_delay)
            )
        raise RuntimeError(f"failed to start worker {spec} after {self.max_attempts} attempts: {last}")

    def stop(self) -> None:
        """Send {"quit":1} to each worker port, then reap processes."""
        import socket as _socket

        for handle in self.handles:
            for p in range(handle.spec.port, handle.spec.port + handle.spec.threads):
                try:
                    sock = _socket.create_connection((handle.spec.addr, p), timeout=5)
                    send_framed(sock, '{"quit": 1}')
                    sock.close()
                except OSError:
                    pass
        for handle in self.handles:
            try:
                handle.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                handle.stop()
        self.handles.clear()


# ---------------------------------------------------------------------------
# elastic cloud provisioning (the reference's EC2 backend, src/aws.cpp)

AWS_DEFAULT_AMI = "ami-e3106686"  # aws.h:15-18
AWS_DEFAULT_INSTANCE_TYPE = "m3.medium"
AWS_DEFAULT_INSTANCE_CORES = 1
AWS_DEFAULT_USER = "ec2-user"


class ElasticPool:
    """Provision temporary cloud instances as workers via the aws CLI,
    with termination guaranteed on exit and on fatal signals
    (AWS::terminateInstancesSilently + handleSignal chain,
    aws.cpp:107-217)."""

    def __init__(self, ami: str = AWS_DEFAULT_AMI,
                 instance_type: str = AWS_DEFAULT_INSTANCE_TYPE,
                 user: str = AWS_DEFAULT_USER,
                 key_pair: str = "", security_group: str = "",
                 aws_path: str = "aws"):
        self.ami = ami
        self.instance_type = instance_type
        self.user = user
        self.key_pair = key_pair
        self.security_group = security_group
        self.aws_path = aws_path
        self.instance_ids: List[str] = []
        self._install_cleanup()

    def _aws(self, args: List[str]) -> dict:
        out = subprocess.run(
            [self.aws_path] + args, check=True, capture_output=True, text=True
        )
        return json.loads(out.stdout) if out.stdout.strip() else {}

    def startup_script(self, bootstrap: str) -> str:
        """User-data script installing and starting the worker (the
        reference git-clones and builds itself, qmodel.cpp:1146-1153)."""
        return "#!/bin/bash\n" + bootstrap

    def launch(self, count: int, bootstrap_script: str) -> List[str]:
        user_data = base64.b64encode(
            self.startup_script(bootstrap_script).encode()
        ).decode()
        args = [
            "ec2", "run-instances",
            "--image-id", self.ami,
            "--count", str(count),
            "--instance-type", self.instance_type,
            "--user-data", user_data,
        ]
        if self.key_pair:
            args += ["--key-name", self.key_pair]
        if self.security_group:
            args += ["--security-groups", self.security_group]
        data = self._aws(args)
        self.instance_ids = [i["InstanceId"] for i in data.get("Instances", [])]
        self._aws(["ec2", "wait", "instance-status-ok", "--instance-ids"]
                  + self.instance_ids)
        desc = self._aws(["ec2", "describe-instances", "--instance-ids"]
                         + self.instance_ids)
        addrs = []
        for res in desc.get("Reservations", []):
            for inst in res.get("Instances", []):
                addrs.append(inst.get("PublicIpAddress") or inst.get("PrivateIpAddress"))
        return addrs

    def reboot(self, instance_id: str) -> None:
        self._aws(["ec2", "reboot-instances", "--instance-ids", instance_id])

    def terminate_all(self) -> None:
        if self.instance_ids:
            try:
                self._aws(["ec2", "terminate-instances", "--instance-ids"]
                          + self.instance_ids)
            except Exception:
                pass
            self.instance_ids = []

    def _install_cleanup(self) -> None:
        atexit.register(self.terminate_all)
        for sig in (signal.SIGINT, signal.SIGTERM):
            prev = signal.getsignal(sig)

            def handler(signum, frame, prev=prev):
                self.terminate_all()
                if callable(prev):
                    prev(signum, frame)
                else:
                    raise SystemExit(128 + signum)

            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread


# ---------------------------------------------------------------------------
# file distribution (the reference's S3/rsync staging, qmodel.cpp:1062-1085)

SYNC_STAGING_DIR = "/tmp/quaff"


def sync_to_remote(filename: str, spec: RemoteServerSpec,
                   rsync_path: str = "rsync", ssh_path: str = "ssh") -> None:
    target = f"{spec.user}@{spec.addr}" if spec.user else spec.addr
    subprocess.run(
        [ssh_path, target, f"mkdir -p {SYNC_STAGING_DIR}"], check=True
    )
    subprocess.run(
        [rsync_path, "-e", ssh_path, filename,
         f"{target}:{SYNC_STAGING_DIR}/"], check=True
    )


def sync_from_bucket(bucket: str, filename: str, aws_path: str = "aws") -> None:
    import os

    os.makedirs(SYNC_STAGING_DIR, exist_ok=True)
    subprocess.run(
        [aws_path, "s3", "sync", f"s3://{bucket}", SYNC_STAGING_DIR,
         "--exclude", "*", "--include", filename.split("/")[-1]],
        check=True,
    )


def sync_to_bucket(bucket: str, filename: str, aws_path: str = "aws") -> None:
    import os

    subprocess.run(
        [aws_path, "s3", "cp", filename, f"s3://{bucket}/"], check=True
    )
