"""The WKV6 recurrence of RWKV-6 ("Finch") time mixing."""
