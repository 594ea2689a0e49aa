"""kubefed CLI (reference ``federation/pkg/kubefed``): init / join /
unjoin / get-clusters against a federation apiserver."""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from ..api.meta import ObjectMeta
from ..client.clientset import Clientset
from ..client.remote import RemoteStore
from ..store.store import AlreadyExistsError, NotFoundError
from .types import Cluster


def join(cs: Clientset, name: str, server: str, token: str = "",
         zone: str = "", region: str = "", out=None) -> int:
    out = out or sys.stdout
    try:
        cs.client_for("Cluster").create(Cluster(
            meta=ObjectMeta(name=name), server_address=server, token=token,
            zone=zone, region=region))
    except AlreadyExistsError:
        out.write(f'Error: cluster "{name}" already joined\n')
        return 1
    out.write(f"cluster/{name} joined\n")
    return 0


def unjoin(cs: Clientset, name: str, out=None) -> int:
    out = out or sys.stdout
    try:
        cs.client_for("Cluster").delete(name, "")
    except NotFoundError:
        out.write(f'Error: cluster "{name}" not found\n')
        return 1
    out.write(f"cluster/{name} unjoined\n")
    return 0


def get_clusters(cs: Clientset, out=None) -> int:
    out = out or sys.stdout
    rows = [("NAME", "SERVER", "READY", "ZONE")]
    for c in cs.client_for("Cluster").list("")[0]:
        rows.append((c.meta.name, c.server_address, str(c.ready), c.zone))
    widths = [max(len(str(r[i])) for r in rows) for i in range(4)]
    for r in rows:
        out.write("  ".join(str(v).ljust(w) for v, w in zip(r, widths)).rstrip() + "\n")
    return 0


def main(argv: Optional[list] = None, clientset: Optional[Clientset] = None,
         out=None) -> int:
    ap = argparse.ArgumentParser(prog="kubefed")
    ap.add_argument("--host", default="http://127.0.0.1:8080",
                    help="federation apiserver")
    ap.add_argument("--token", default=None)
    sub = ap.add_subparsers(dest="verb", required=True)
    p = sub.add_parser("join")
    p.add_argument("name")
    p.add_argument("--cluster-server", required=True)
    p.add_argument("--cluster-token", default="")
    p.add_argument("--zone", default="")
    p.add_argument("--region", default="")
    p = sub.add_parser("unjoin")
    p.add_argument("name")
    sub.add_parser("get-clusters")
    args = ap.parse_args(argv)
    cs = clientset or Clientset(RemoteStore(args.host, token=args.token))
    if args.verb == "join":
        return join(cs, args.name, args.cluster_server, args.cluster_token,
                    args.zone, args.region, out)
    if args.verb == "unjoin":
        return unjoin(cs, args.name, out)
    return get_clusters(cs, out)


if __name__ == "__main__":
    sys.exit(main())
