"""Cluster provisioning EXECUTOR — actually runs host setup, not just
renders it (the port's version of ``deeplearning4j_tpu/utils/provision.py``).

≙ the reference's EC2 provisioning pair: ClusterSetup
(deeplearning4j-scaleout/deeplearning4j-aws/.../provision/
ClusterSetup.java:24 — spins up the boxes then provisions master +
workers) and HostProvisioner (HostProvisioner.java:24 — per-host SSH
session: runRemoteCommand, uploadForDeployment, uploadAndRun,
addKeyFile). Re-expressed for the GPU world: hosts are GPU VMs with
H100s created via ``gcloud compute instances create`` (the machine type
names the cards), per-host commands ride ``gcloud compute ssh`` / ``scp``
(or plain ssh for generic hosts).

Everything executes through an injectable :class:`CommandRunner`, so
the zero-egress environment (and the tests) drive the full
orchestration against a :class:`RecordingRunner` while production uses
:class:`SubprocessRunner` — the reference hard-wired JSch and was
untestable without live EC2. The steps, their order, the hosts and the
scripts are the JAX package's ``ClusterSetup``'s; only the commands
that create, reach and delete a VM name a GPU VM instead of a TPU VM.
"""

from __future__ import annotations

import dataclasses
import shlex
import subprocess
from typing import Protocol, Sequence

from deeplearning4j_tpu_torch.utils.cloud_io import (
    GPU_IMAGE_FAMILY,
    GPU_IMAGE_PROJECT,
    GPU_MACHINE_TYPE,
    render_gpu_vm_provision,
)


@dataclasses.dataclass
class CommandResult:
    returncode: int
    stdout: str = ""
    stderr: str = ""


class CommandRunner(Protocol):
    def run(self, argv: Sequence[str]) -> CommandResult: ...


class SubprocessRunner:
    """Executes for real (production path)."""

    def __init__(self, timeout: float | None = 600.0):
        self.timeout = timeout

    def run(self, argv: Sequence[str]) -> CommandResult:
        p = subprocess.run(
            list(argv), capture_output=True, text=True,
            timeout=self.timeout,
        )
        return CommandResult(p.returncode, p.stdout, p.stderr)


class RecordingRunner:
    """Records every command; used for --dry-run and offline tests.

    ``responses`` optionally maps a substring to a canned
    :class:`CommandResult` so failure paths are testable.
    """

    def __init__(self, responses: dict[str, CommandResult] | None = None):
        self.commands: list[list[str]] = []
        self.responses = responses or {}

    def run(self, argv: Sequence[str]) -> CommandResult:
        argv = list(argv)
        self.commands.append(argv)
        joined = " ".join(argv)
        for key, result in self.responses.items():
            if key in joined:
                return result
        return CommandResult(0)


class ProvisionError(RuntimeError):
    """A provisioning command failed; carries the failing argv + stderr."""


def _check(runner: CommandRunner, argv: Sequence[str]) -> CommandResult:
    res = runner.run(argv)
    if res.returncode != 0:
        raise ProvisionError(
            f"command failed ({res.returncode}): "
            f"{shlex.join(argv)}\n{res.stderr[-2000:]}"
        )
    return res


class HostProvisioner:
    """Per-host command/upload session (≙ HostProvisioner.java:24).

    ``gpu_vm=True`` routes through ``gcloud compute ssh/scp`` (a GPU VM on
    GCP); ``False`` uses plain ssh/scp for generic hosts (the reference's
    regime).
    """

    def __init__(self, host: str, user: str | None = None,
                 zone: str | None = None, key_file: str | None = None,
                 gpu_vm: bool = False, runner: CommandRunner | None = None):
        self.host = host
        self.user = user
        self.zone = zone
        self.key_file = key_file
        self.gpu_vm = gpu_vm
        self.runner = runner or SubprocessRunner()

    def _target(self) -> str:
        return f"{self.user}@{self.host}" if self.user else self.host

    def _ssh_base(self) -> list[str]:
        if self.gpu_vm:
            cmd = ["gcloud", "compute", "ssh", self._target()]
            if self.zone:
                cmd.append(f"--zone={self.zone}")
            return cmd
        cmd = ["ssh"]
        if self.key_file:
            cmd += ["-i", self.key_file]
        return cmd + [self._target()]

    def run_remote_command(self, command: str) -> CommandResult:
        """≙ HostProvisioner.runRemoteCommand:89 (raises on rc != 0,
        like the reference's 'exec did not succeed' path)."""
        if self.gpu_vm:
            argv = self._ssh_base() + [f"--command={command}"]
        else:
            argv = self._ssh_base() + [command]
        return _check(self.runner, argv)

    def upload_for_deployment(self, src: str, dst: str) -> None:
        """≙ HostProvisioner.uploadForDeployment:138 (scp a file/dir)."""
        if self.gpu_vm:
            argv = ["gcloud", "compute", "scp", src,
                    f"{self._target()}:{dst}"]
            if self.zone:
                argv.append(f"--zone={self.zone}")
        else:
            argv = ["scp"]
            if self.key_file:
                argv += ["-i", self.key_file]
            argv += [src, f"{self._target()}:{dst}"]
        _check(self.runner, argv)

    def upload_and_run(self, script: str, root_dir: str = "") -> None:
        """≙ HostProvisioner.uploadAndRun:80 — upload a setup script,
        chmod, execute."""
        name = script.rsplit("/", 1)[-1]
        remote = f"{root_dir.rstrip('/')}/{name}" if root_dir else name
        self.upload_for_deployment(script, remote)
        # execute by explicit path: absolute stays as-is, relative gets
        # ./ — both quoted (an unquoted exec of a name with spaces would
        # chmod one file and run another)
        exec_path = remote if remote.startswith("/") else f"./{remote}"
        self.run_remote_command(
            f"chmod +x {shlex.quote(remote)} && {shlex.quote(exec_path)}"
        )

    def add_key_file(self, pub_key_path: str) -> None:
        """≙ HostProvisioner.addKeyFile:148 — append a public key to
        authorized_keys (read locally, appended remotely)."""
        with open(pub_key_path) as f:
            key = f.read().strip()
        self.run_remote_command(
            "mkdir -p ~/.ssh && "
            f"echo {shlex.quote(key)} >> ~/.ssh/authorized_keys"
        )


@dataclasses.dataclass
class ClusterSpec:
    """What to provision (≙ ClusterSetup's args4j options, GPU-flavored:
    worker count, machine type, region/zone, VM image, setup scripts)."""

    name: str = "dl4j"
    num_workers: int = 1
    machine_type: str = GPU_MACHINE_TYPE
    zone: str = "us-central1-a"
    image_family: str = GPU_IMAGE_FAMILY
    image_project: str = GPU_IMAGE_PROJECT
    master_script: str | None = None
    worker_script: str | None = None


class ClusterSetup:
    """Provision a whole cluster (≙ ClusterSetup.java:24: create the
    boxes, then provision master + workers with their setup scripts).

    The master is ``<name>-master``; workers ``<name>-worker-<i>``. All
    commands flow through the injected runner — pass a
    :class:`RecordingRunner` for a dry run (the CLI's default)."""

    def __init__(self, spec: ClusterSpec,
                 runner: CommandRunner | None = None):
        self.spec = spec
        self.runner = runner or SubprocessRunner()

    def _hosts(self) -> list[tuple[str, str | None]]:
        s = self.spec
        hosts = [(f"{s.name}-master", s.master_script)]
        hosts += [
            (f"{s.name}-worker-{i}", s.worker_script)
            for i in range(s.num_workers)
        ]
        return hosts

    def provision(self) -> list[str]:
        """Create every VM, then run its setup script (when given).
        Returns the provisioned host names, master first."""
        s = self.spec
        names = []
        for host, script in self._hosts():
            _check(self.runner, render_gpu_vm_provision(
                host, machine_type=s.machine_type, zone=s.zone,
                image_family=s.image_family, image_project=s.image_project,
            ))
            if script:
                HostProvisioner(
                    host, zone=s.zone, gpu_vm=True, runner=self.runner
                ).upload_and_run(script)
            names.append(host)
        return names

    def teardown(self) -> None:
        """Delete every VM of the cluster (reverse order). Best-effort:
        a failed delete must not leave the REMAINING (billed) VMs
        running — every delete is attempted, failures collected and
        raised once at the end."""
        failures = []
        for host, _ in reversed(self._hosts()):
            try:
                _check(self.runner, [
                    "gcloud", "compute", "instances", "delete", host,
                    f"--zone={self.spec.zone}", "--quiet",
                ])
            except ProvisionError as e:
                failures.append(str(e))
        if failures:
            raise ProvisionError(
                f"{len(failures)} delete(s) failed:\n" + "\n".join(failures)
            )
