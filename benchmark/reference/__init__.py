"""The plain reference of the served path: numpy only.

It works out identities, the ipcache and the policy again from a
configuration's declaration (``declare.py`` of each configuration: the
endpoints, identities, prefixes, services and rule documents, in the order
they are declared), and classifies a batch against a conntrack table with
the datapath's batch semantics (every row sees the table as of the batch
start; the table's changes are applied afterwards as one aggregate). It
imports nothing of the program.
"""
