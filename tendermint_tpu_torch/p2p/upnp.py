"""UPnP IGD probe — NAT discovery + external-IP/port-mapping queries
(ref: p2p/upnp/upnp.go, probe.go; `probe_upnp` CLI).

SSDP M-SEARCH discovery over UDP multicast, then SOAP GetExternalIPAddress /
AddPortMapping against the gateway's control URL. Sandboxed/egress-less
environments simply time out at discovery — the probe reports that rather
than failing.

The port's copy of the reference package's ``p2p/upnp.py``; the
``probe_upnp`` command runs ``probe``.
"""

from __future__ import annotations

import re
import socket
import urllib.request
from dataclasses import dataclass
from typing import Optional

SSDP_ADDR = ("239.255.255.250", 1900)
SSDP_ST = "urn:schemas-upnp-org:device:InternetGatewayDevice:1"
WANIP_ST = "urn:schemas-upnp-org:service:WANIPConnection:1"


@dataclass
class UPNPCapabilities:
    """probe.go capabilities summary."""

    found_gateway: bool = False
    location: str = ""
    external_ip: str = ""
    port_mapping: bool = False
    error: str = ""


def discover(timeout: float = 3.0) -> Optional[str]:
    """SSDP M-SEARCH; returns the IGD description URL or None (upnp.go:48)."""
    msg = (
        "M-SEARCH * HTTP/1.1\r\n"
        f"HOST: {SSDP_ADDR[0]}:{SSDP_ADDR[1]}\r\n"
        'MAN: "ssdp:discover"\r\n'
        "MX: 2\r\n"
        f"ST: {SSDP_ST}\r\n\r\n"
    ).encode()
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.settimeout(timeout)
    try:
        sock.sendto(msg, SSDP_ADDR)
        while True:
            data, _ = sock.recvfrom(2048)
            m = re.search(rb"(?i)location:\s*(\S+)", data)
            if m:
                return m.group(1).decode()
    except (socket.timeout, OSError):
        return None
    finally:
        sock.close()


def _soap(control_url: str, action: str, body_xml: str = "") -> Optional[str]:
    envelope = f"""<?xml version="1.0"?>
<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/"
 s:encodingStyle="http://schemas.xmlsoap.org/soap/encoding/">
<s:Body><u:{action} xmlns:u="{WANIP_ST}">{body_xml}</u:{action}></s:Body>
</s:Envelope>"""
    req = urllib.request.Request(
        control_url,
        data=envelope.encode(),
        headers={
            "Content-Type": 'text/xml; charset="utf-8"',
            "SOAPAction": f'"{WANIP_ST}#{action}"',
        },
    )
    try:
        with urllib.request.urlopen(req, timeout=3) as resp:
            return resp.read().decode()
    except Exception:
        return None


def probe(timeout: float = 3.0) -> UPNPCapabilities:
    """Full capability probe (probe.go Probe): discovery → device description
    → external IP → test port mapping (add + delete). Never raises — every
    failure lands in .error."""
    try:
        return _probe(timeout)
    except Exception as e:
        return UPNPCapabilities(error=f"probe failed: {e}")


def _probe(timeout: float) -> UPNPCapabilities:
    caps = UPNPCapabilities()
    location = discover(timeout)
    if location is None:
        caps.error = "no UPnP gateway responded (SSDP timeout)"
        return caps
    caps.found_gateway = True
    caps.location = location
    try:
        with urllib.request.urlopen(location, timeout=timeout) as resp:
            desc = resp.read().decode()
    except Exception as e:
        caps.error = f"could not fetch device description: {e}"
        return caps
    m = re.search(
        rf"<serviceType>{re.escape(WANIP_ST)}</serviceType>.*?"
        r"<controlURL>([^<]+)</controlURL>",
        desc,
        re.S,
    )
    if not m:
        caps.error = "gateway exposes no WANIPConnection service"
        return caps
    control = m.group(1)
    if not control.startswith("http"):
        # resolve relative control URLs against <URLBase> or the location
        base_m = re.search(r"<URLBase>([^<]+)</URLBase>", desc)
        base = (base_m.group(1) if base_m else location).rstrip("/")
        if not control.startswith("/"):
            control = "/" + control
        parts = base.split("/", 3)
        control = f"{parts[0]}//{parts[2]}{control}"
    out = _soap(control, "GetExternalIPAddress")
    if out:
        ip = re.search(r"<NewExternalIPAddress>([^<]*)<", out)
        if ip:
            caps.external_ip = ip.group(1)
    add = _soap(
        control,
        "AddPortMapping",
        "<NewRemoteHost></NewRemoteHost><NewExternalPort>26656</NewExternalPort>"
        "<NewProtocol>TCP</NewProtocol><NewInternalPort>26656</NewInternalPort>"
        f"<NewInternalClient>{_local_ip()}</NewInternalClient>"
        "<NewEnabled>1</NewEnabled><NewPortMappingDescription>tm-probe"
        "</NewPortMappingDescription><NewLeaseDuration>0</NewLeaseDuration>",
    )
    if add is not None:
        caps.port_mapping = True
        _soap(
            control,
            "DeletePortMapping",
            "<NewRemoteHost></NewRemoteHost><NewExternalPort>26656"
            "</NewExternalPort><NewProtocol>TCP</NewProtocol>",
        )
    return caps


def _local_ip() -> str:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("10.255.255.255", 1))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()
