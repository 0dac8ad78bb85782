"""The datapath's fixed numbers, as the configurations state them (Cilium's
defaults; the reason codes of ``bpf/lib/drop.h`` as the system numbers
them)."""

PROTO_ICMP = 1
PROTO_TCP = 6
PROTO_UDP = 17
PROTO_SCTP = 132

DIR_EGRESS = 0
DIR_INGRESS = 1

#: drop reasons (0 = forwarded)
OK = 0
POLICY = 130
CT_FULL = 137
#: an L7 rule set matched none of the request's tokens
POLICY_L7 = 180
REASON_BINS = 256

#: conntrack status of a row as of its batch's start
NEW, ESTABLISHED, REPLY = 0, 1, 2

#: lifetimes (s): SYN, established TCP, other protocols, closing
CT_LIFETIME_SYN = 60
CT_LIFETIME_TCP = 21600
CT_LIFETIME_NONTCP = 60
CT_LIFETIME_CLOSE = 10

CT_FLAG_SEEN_NON_SYN = 1
CT_FLAG_TX_CLOSING = 2
CT_FLAG_RX_CLOSING = 4

TCP_FIN = 0x01
TCP_SYN = 0x02
TCP_RST = 0x04
TCP_ACK = 0x10

PROBE_DEPTH = 8
KEY_WORDS = 10

#: L7-lite: a request's method as its index here (255: the row carries
#: none) and the first 64 bytes of its path, zero-padded
HTTP_METHODS = ("GET", "POST", "PUT", "DELETE", "HEAD", "OPTIONS", "PATCH",
                "TRACE", "CONNECT")
HTTP_METHOD_NONE = 255
PATH_BYTES = 64

#: reserved identities
IDENTITY_WORLD = 2
IDENTITY_HEALTH = 4
RESERVED = {"world": IDENTITY_WORLD, "health": IDENTITY_HEALTH}
#: where numbered identities start: cluster-scoped labels, and CIDRs
CLUSTER_IDENTITY_BASE = 256
LOCAL_IDENTITY_SCOPE = 1 << 24

#: the CT table's arrays
CT_FIELDS = ("keys", "expiry", "created", "flags", "pkts_fwd", "pkts_rev",
             "rev_nat")
