"""replica.straggler: the busiest card's kernel time over the mean of the
cards' kernel times in the traced window (copies and sets not counted;
1.0: the replicas share the work evenly). None with fewer than two cards
or no kernel."""

COPIES = ("Memcpy", "Memset")


def read(rec):
    cards = rec.get("cards") or []
    if len(cards) < 2:
        return None
    times = dict.fromkeys(cards, 0)
    for e in rec["events"]:
        if e["dev"] in times and not e["name"].startswith(COPIES):
            times[e["dev"]] += e["end"] - e["start"]
    mean = sum(times.values()) / len(times)
    if mean <= 0:
        return None
    return max(times.values()) / mean
