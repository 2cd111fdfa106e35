"""A-statistic genome-size estimation.

Replicates OverlapGraph::estimateGenomeSize (OverlapGraph.cpp:995-1041):
iterate the Myers A-statistic fixpoint over forward edges (source <
destination) until the estimate stabilizes or 10 rounds pass.  The first
round seeds from edges longer than 500bp; later rounds keep edges whose
a-statistic >= aStatisticsThreshold(3) and offset >= minDelta(1000)
(Common.h:40-41).  Unused by the metagenome pipeline (main.cpp never calls
it) but part of the reference's public OverlapGraph API (OverlapGraph.h:63).
"""

import math


class GenomeSizeMixin:
    def estimate_genome_size(self):
        ds = self.ds
        previous = 0
        current = 0
        counter = 0
        while True:
            counter += 1
            delta_sum = 0
            freq_sum = 0
            for i in range(1, ds.number_of_unique_reads + 1):
                for e in self.adj[i]:
                    if e.source >= e.destination:
                        continue
                    delta = e.offset
                    freq = 0
                    for rid in e.list_reads:
                        freq += int(ds.frequencies[rid])
                    if previous != 0:
                        a_stat = (float(delta)
                                  * (float(ds.number_of_reads)
                                     / float(previous))
                                  - float(freq) * math.log(2.0))
                        if (a_stat >= self.cfg.a_statistics_threshold
                                and delta >= self.cfg.min_delta):
                            delta_sum += delta
                            freq_sum += freq
                    elif e.offset > 500:
                        delta_sum += delta
                        freq_sum += freq
            previous = current
            current = (int(float(ds.number_of_reads) / float(freq_sum)
                           * float(delta_sum)) if freq_sum else 0)
            self.log("Current estimated genome size: %d" % current)
            if current == previous or counter >= 10:
                break
        self.estimated_genome_size = current
        self.log("Final estimated genome size: %d" % current)
        return True
