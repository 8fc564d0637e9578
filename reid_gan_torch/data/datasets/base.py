"""Base dataset with statistics printing
(parity: CC/clustercontrast/utils/data/base_dataset.py)."""


class BaseImageDataset:
    train = ()
    query = ()
    gallery = ()

    @staticmethod
    def get_imagedata_info(data):
        pids, cams = set(), set()
        for _, pid, camid in data:
            pids.add(pid)
            cams.add(camid)
        return len(pids), len(data), len(cams)

    def print_dataset_statistics(self, train, query, gallery):
        nt_p, nt_i, nt_c = self.get_imagedata_info(train)
        nq_p, nq_i, nq_c = self.get_imagedata_info(query)
        ng_p, ng_i, ng_c = self.get_imagedata_info(gallery)
        print("Dataset statistics:")
        print("  ----------------------------------------")
        print("  subset   | # ids | # images | # cameras")
        print("  ----------------------------------------")
        print(f"  train    | {nt_p:5d} | {nt_i:8d} | {nt_c:9d}")
        print(f"  query    | {nq_p:5d} | {nq_i:8d} | {nq_c:9d}")
        print(f"  gallery  | {ng_p:5d} | {ng_i:8d} | {ng_c:9d}")
        print("  ----------------------------------------")
