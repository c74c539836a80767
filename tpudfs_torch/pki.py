"""A throwaway test PKI for TLS clusters — the port's own copy of
``tpudfs/testing/certs.py::make_test_pki``.

It runs the ``openssl`` command-line tool to make a self-signed CA and a
server and a client key pair signed by it, for ``127.0.0.1`` and
``localhost``. The servers take the server pair (``--tls-cert``,
``--tls-key``, ``--tls-ca``); a client takes
``ClientTls(ca_path=paths["ca"])``, and the client pair when the servers
require client certificates (mTLS). Production deployments bring their
own PKI; this one backs local clusters and tests.
"""

from __future__ import annotations

import ipaddress
import subprocess
from pathlib import Path


def _openssl(*args: str, input_text: str | None = None) -> None:
    subprocess.run(["openssl", *args], check=True, capture_output=True,
                   input=input_text.encode() if input_text else None)


def _san(host: str) -> str:
    try:
        ipaddress.ip_address(host)
        return f"IP:{host}"
    except ValueError:
        return f"DNS:{host}"


def make_test_pki(root: str | Path,
                  hosts: tuple[str, ...] = ("127.0.0.1", "localhost")) -> dict:
    """Create ``ca.pem`` plus server and client key pairs signed by it under
    ``root``. Returns the path map: ``{ca, server_cert, server_key,
    client_cert, client_key}``."""
    d = Path(root)
    d.mkdir(parents=True, exist_ok=True)
    ca_key, ca = d / "ca.key", d / "ca.pem"
    _openssl("req", "-x509", "-newkey", "rsa:2048", "-nodes", "-days", "2",
             "-keyout", str(ca_key), "-out", str(ca),
             "-subj", "/CN=tpudfs-test-ca")
    san = ",".join(_san(h) for h in hosts)
    out = {"ca": str(ca)}
    for role in ("server", "client"):
        key, csr, cert = d / f"{role}.key", d / f"{role}.csr", d / f"{role}.pem"
        _openssl("req", "-newkey", "rsa:2048", "-nodes",
                 "-keyout", str(key), "-out", str(csr),
                 "-subj", f"/CN=tpudfs-test-{role}")
        _openssl("x509", "-req", "-in", str(csr), "-CA", str(ca),
                 "-CAkey", str(ca_key), "-CAcreateserial", "-days", "2",
                 "-out", str(cert), "-extfile", "/dev/stdin",
                 input_text=f"subjectAltName={san}\n")
        out[f"{role}_cert"] = str(cert)
        out[f"{role}_key"] = str(key)
    return out
